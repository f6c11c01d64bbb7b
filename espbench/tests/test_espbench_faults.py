"""The check fails what it must: the control (the reference in the
program's place with a float32 IDCT) and runs whose timed path is broken
underneath, each through the rest of a run at a tiny size on the CPU."""

import pytest
import torch

from espflix_tpu_torch.runtime import chain as CH

from espbench.tests.tiny import run_tiny, tiny_cell


CELLS = ["ntsc.chain", "ntsc.served"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    res = run_tiny(tiny_cell(name), seed=2**31 + 9, control=True)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["planes"]["value"] > checks["planes"]["limit"]
    assert checks["field_sum"]["value"] > checks["field_sum"]["limit"]


def _state_unchanged(out, sbc_state, ds_state, new):
    return sbc_state, ds_state, out


def _half_left_out(out, sbc_state, ds_state, new):
    n = out["err"].shape[0]
    for k in ("y", "u", "v", "field_sum", "pdm_sum"):
        out[k] = out[k].clone()
        out[k][n // 2:] = 0
    return new + (out,)


def _answer_altered(out, sbc_state, ds_state, new):
    out["y"] = out["y"].clone()
    out["y"][0, 5, 5] ^= 1
    return new + (out,)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    orig = CH.FullChain.tick

    def tick(self, x, frames, sbc_state, ds_state, *a, **kw):
        s, d, out = orig(self, x, frames, sbc_state, ds_state, *a, **kw)
        return fault(out, sbc_state, ds_state, (s, d))

    monkeypatch.setattr(CH.FullChain, "tick", tick)
    res = run_tiny(tiny_cell(name))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_modulator_state_unchanged_over_a_chunk_is_not_correct(
        monkeypatch, name):
    """Every tick carries the modulator's state to the next, but a chunk
    hands back the state it was given, so each chunk starts over."""
    orig = CH.FullChain.forward

    def forward(self, xs, frames, sbc_state, ds_state, *a, **kw):
        frames, sbc_state, _ds, outs = orig(self, xs, frames, sbc_state,
                                            ds_state, *a, **kw)
        return frames, sbc_state, ds_state, outs

    monkeypatch.setattr(CH.FullChain, "forward", forward)
    res = run_tiny(tiny_cell(name))
    assert not res["correct"]
    assert res["checks"]["pdm_carry"]["value"] > 0
