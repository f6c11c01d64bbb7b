"""The least bytes a tick's work needs, and the card's published peaks.

The bytes are counted from the tick's inputs and from the reference's
own parse of them (reference/refdec.py's per-picture counts: intra
macroblocks, predicted macroblocks with a vector, zero-vector copies,
coded blocks, coded bytes), never from the program's intermediates, so
the count reads the same work whatever implements it.  Each function of
the chain counts every input byte read once and every output byte
written once:

- scan: reads the picture's coded bytes; writes 64 int16 coefficients a
  coded block and an 8-byte record (type, vector, pattern) a macroblock;
- dequant + IDCT: reads and writes 64 int16 a coded block;
- prediction + compose + put: reads the reference's 384 bytes (4:2:0)
  of each predicted or copied macroblock and the coded blocks' int16
  residuals; writes the picture, 384 bytes a macroblock;
- composite pair: reads the picture, the 16 x 80 OSD bytes and 12 bytes
  of state; writes a 4-byte checksum, and both whole fields of a tapped
  lane;
- SBC: reads the tick's frames; writes 128 int16 samples a frame and
  channel;
- PDM: reads those samples; writes two 16-bit words a sample.

Byte-only on purpose: no operations bound rests on an assumed cycle
model, so a share over 100% means the count is wrong.
"""

from __future__ import annotations

from espbench.reference.video_tables import Geometry

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W limit
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}
MB_BYTES = 384          # a 16x16 macroblock in 4:2:0 bytes
BLOCK_BYTES = 128       # 64 int16
MB_RECORD = 8


def picture_bytes(st: dict, n_mbs: int) -> int:
    """The decode's least bytes for one picture from its parse counts."""
    scan = st["bytes"] + st["blocks"] * BLOCK_BYTES + n_mbs * MB_RECORD
    idct = 2 * st["blocks"] * BLOCK_BYTES
    compose = ((st["pred"] + st["copy"]) * MB_BYTES
               + st["blocks"] * BLOCK_BYTES + n_mbs * MB_BYTES)
    return scan + idct + compose


def output_bytes(cfg: dict, n_mbs: int, frame_bytes: int) -> int:
    """The output functions' least bytes for one lane-tick (untapped)."""
    F, ch = cfg["frames_per_tick"], cfg["audio"]["channels"]
    samples = F * 128 * ch
    composite = n_mbs * MB_BYTES + 16 * 80 + 12 + 4
    sbc = F * frame_bytes + 2 * samples
    pdm = 2 * samples + 2 * 2 * samples
    return composite + sbc + pdm


def tap_bytes(cfg: dict) -> int:
    """Both whole fields of one tapped lane."""
    g = Geometry(cfg["standard"] == "pal")
    return 2 * g.line_count * g.line_width


def chunk_bytes(ref: list, t, cfg: dict) -> int:
    """Least bytes of one replayed device-fed chunk: every lane's
    pictures over the chunk, its outputs, and the taps."""
    v = cfg["video"]
    n_mbs = ((v["width"] + 15) >> 4) * ((v["height"] + 15) >> 4)
    per_stream = [sum(picture_bytes(st, n_mbs) for st in stats)
                  for _pics, stats in ref]
    frame_bytes = len(t.streams[0].audio[0][0])
    lanes_of = [int((t.stream_of == s).sum()) for s in range(len(ref))]
    decode = sum(n * b for n, b in zip(lanes_of, per_stream))
    out = t.K * t.lanes * output_bytes(cfg, n_mbs, frame_bytes)
    return decode + out + t.K * len(t.checked) * tap_bytes(cfg)


def least_seconds(n_bytes: int) -> float:
    """Seconds n_bytes take at the H100's published HBM bandwidth."""
    return n_bytes / PEAKS["H100"]["hbm_bytes_per_s"]
