"""The port's serving CLI on the CPU: --stage decode for each dispatch.

python3 -m espflix_tpu_torch.tools.serve_scenario --stage decode
--device cpu --transport file on two lanes, 6 ticks of one-GOP titles:
the output line has the JAX tool's keys (serve_scenario.py:496-515),
every lane decodes, the injected faults are caught and resynced, and
the half-time snapshot restores into a second fleet that decodes.  The
ScenarioStats themselves are held equal to the JAX tool's in
tests/test_torch_serve_decode.py.
"""

import json

import pytest
import torch

from espflix_tpu_torch.tools import serve_scenario as TSS
from tests.torch_fleet import python_feed

torch.set_num_threads(1)

# the JAX tool's output line (serve_scenario.py:496-515)
JSON_KEYS = {"lanes", "ticks", "stage", "dispatch", "full_ticks",
             "tap_field_bytes", "min_lane_frames", "frames",
             "audio_lane_ticks", "errors", "resyncs", "actions",
             "snapshot_restored", "restored_decodes", "wall_s",
             "frames_per_s", "rt_streams_per_chip"}


@pytest.mark.parametrize("dispatch", ["pipelined", "chunk"])
def test_cli_stage_decode_on_cpu(dispatch, capsys, python_feed):
    out = TSS.main(["--stage", "decode", "--dispatch", dispatch,
                    "--device", "cpu", "--transport", "file", "--lanes",
                    "2", "--ticks", "6", "--titles", "2", "--gops", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(out) == JSON_KEYS
    assert out["stage"] == "decode" and out["dispatch"] == dispatch
    assert out["min_lane_frames"] >= 1 and out["full_ticks"] == 0
    assert out["errors"] >= 1 and out["resyncs"] >= 1
    assert out["snapshot_restored"] == 2 and out["restored_decodes"]


def test_cli_defaults_to_the_card():
    """Without --device the tool builds its fleet on the card: on a
    machine without CUDA that raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TSS.build_fleet("file:///nonexistent", 1, 1)
