"""Typed configuration tree for the framework.

Copied from espflix_tpu/config.py; tests/test_torch_isolation.py
pins the copy to the original.

Replaces the reference's compile-time #define soup + NVS runtime store
(SURVEY.md 5.6: video standard, pins, PERF/PLOG toggles, service
indirection URL) with one dataclass tree.  Everything that shapes
compiled device code is here so a config hash keys XLA caches.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class VideoConfig:
    width: int = 352
    height: int = 192
    pal: bool = False            # NTSC by default (espflix.ino:299-300)

    @property
    def mb_width(self) -> int:
        return (self.width + 15) >> 4

    @property
    def mb_height(self) -> int:
        return (self.height + 15) >> 4


@dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 48000
    frame_size: int = 64         # SBC 48k mono bitpool-28
    frames_per_tick: int = 4


@dataclass(frozen=True)
class DecoderConfig:
    words_per_lane: int = 16384  # 64 KiB picture payload budget
    max_slices: int = 12
    # scan-step budget; while_loop exits early when all lanes finish
    max_steps_per_word: int = 32


@dataclass(frozen=True)
class MeshConfig:
    streams_axis: int = 0        # 0 = all devices
    axis_name: str = "streams"


@dataclass(frozen=True)
class ServiceConfig:
    # service indirection: boot URL returns the service root
    # (espflix.cpp:528, init_service 676-695)
    boot_url: str = ""
    service_root: str = ""
    position_store: str = ""     # path for the resume-position JSON


@dataclass(frozen=True)
class ObservabilityConfig:
    event_log: bool = True       # PLOG analogue (streamer.h:11-32)
    event_capacity: int = 4096
    timing: bool = True          # PERF analogue (video.cpp:649-668)


@dataclass(frozen=True)
class Config:
    video: VideoConfig = field(default_factory=VideoConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
