"""The port's IR decoders (runtime/ir.py) and key dispatch
(runtime/input.py), both copies, against the JAX package's.

The pulse trains of tests/test_ir.py (NEC / Apple codes and repeats, a
code split across fields, Atari Flashback for both players and a bad
checksum, RETCON, the WebTV keyboard with a modifier, a release and a
bad parity), plus seeded noise into all four decoders at once, give the
same NEC codes and HID reports field by field; the same key sequences
through dispatch_key leave a session of each package in the same state.
"""

import numpy as np
import pytest

from espflix_tpu.runtime import input as JI
from espflix_tpu.runtime import ir as JIR
from espflix_tpu_torch.runtime import input as TI
from espflix_tpu_torch.runtime import ir as TIR
from tests import test_ir as W
from tests.torch_fleet import python_feed  # noqa: F401 - fixture


def _trains():
    """name -> (protocols, [sample vectors, one per field])."""
    apple = W.apple_code32
    nec = W.runs_to_samples(W.nec_runs(apple(W.ir.APPLE_MENU)))
    rng = np.random.default_rng(5)
    noise = (rng.random(3000) < 0.5).astype(np.uint8)
    return {
        "nec": (("nec",), [W.runs_to_samples(W.nec_runs(apple(k)))
                           for k in (W.ir.APPLE_PLAY, W.ir.APPLE_LEFT)]
                + [W.runs_to_samples(W.nec_repeat_runs())]
                + [np.ones(10, np.uint8)] * 16),
        "nec_split": (("nec",), [nec[:100], nec[100:500], nec[500:]]),
        "nec_noise": (("nec",), [noise, W.runs_to_samples(
            [(0, 255)] + W.nec_runs(apple(W.ir.APPLE_DOWN)))]),
        "flashback": (("flashback",), [
            W.runs_to_samples(W.flashback_runs(W.flashback_code(m, p)))
            for m, p in ((W.ir.GENERIC_FIRE, 0), (W.ir.GENERIC_START, 1))]
            + [W.runs_to_samples(W.flashback_runs(
                W.flashback_code(W.ir.GENERIC_FIRE, 0) ^ 3))]),
        "retcon": (("retcon",), [
            W.runs_to_samples(W.retcon_runs(c))
            for c in (0x0480, 0x9000, 0x0600)]),
        "webtv": (("webtv",), [
            W.runs_to_samples(W.webtv_runs(cmd, W.webtv_byte(k) ^ x))
            for cmd, k, x in ((0x4A, 0x78 >> 1, 0), (0x4A, 0x8C >> 1, 0),
                              (0x5E, 0x8C >> 1, 0), (0x4A, 0x78 >> 1, 1))]),
        "all_noise": (("nec", "flashback", "retcon", "webtv"), [
            (rng.random(4000) < p).astype(np.uint8)
            for p in (0.5, 0.1, 0.9, 0.5)]),
    }


TRAINS = _trains()


def _decode(IR, protocols, fields):
    inp = IR.IrInput(protocols)
    out = []
    for f in fields:
        inp.feed_field(f)
        out.append((inp.get_nec(), inp.get_hid()))
    return out


@pytest.mark.parametrize("name", list(TRAINS))
def test_ir_decoders_match(name):
    protocols, fields = TRAINS[name]
    got = _decode(TIR, protocols, fields)
    assert got == _decode(JIR, protocols, fields)
    if not name.endswith("noise"):
        assert any(n or h for n, h in got), "nothing decoded"


def test_ir_constants_and_apple_map_match():
    names = [n for n, v in vars(JIR).items()
             if n.isupper() and isinstance(v, int)]
    assert names and all(getattr(TIR, n) == getattr(JIR, n) for n in names)
    assert TI.APPLE_MAP == JI.APPLE_MAP
    for code in range(0, 0x10000, 97):
        assert TI.apple_to_key(code << 8) == JI.apple_to_key(code << 8)


KEYS = [TI.KEY_RIGHT, TI.KEY_RIGHT, TI.KEY_LEFT, TI.KEY_SELECT, TI.KEY_UP,
        TI.KEY_DOWN, TI.KEY_RIGHT, TI.KEY_PLAY, TI.KEY_LEFT, TI.KEY_PLAY,
        TI.KEY_MENU, TI.KEY_RIGHT, TI.KEY_PLAY, 0, TI.KEY_DOWN, TI.KEY_UP]


def test_dispatch_key_matches(tmp_path, python_feed):  # noqa: F811
    import importlib

    from espflix_tpu.tools.indexer import make_service

    svc = str(tmp_path / "svc")
    make_service(svc, ["a", "b", "c"], seed=2, n_gops=2, gop=3)
    trace = []
    for pkg, I in (("espflix_tpu", JI), ("espflix_tpu_torch", TI)):
        P = importlib.import_module(f"{pkg}.runtime.player")
        s = P.PlayerSession("file://" + svc)
        assert s.init_service()
        t = []
        for k, key in enumerate(KEYS):
            I.dispatch_key(s, key, keydown=k != 5)
            t.append((s.state.name, s.nav_index, s.speed))
        trace.append(t)
    assert trace[0] == trace[1]
    assert len({st for st, _i, _s in trace[1]}) >= 3
