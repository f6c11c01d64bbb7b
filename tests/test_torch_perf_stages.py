"""The port's stage timer (tools/perf_stages) against the JAX package's.

build_inputs makes the JAX tool's draws in the JAX tool's order, and
every stage of the port, named as the JAX stage it stands for, returns
the JAX stage's checksum (JAX in interpret mode) at 2 lanes for salts 0
and 1: the field stages at the production 352x192, the others at
128x32 (8 x 2 MBs) to keep the JAX side's compiles short.  The
timer's CLI runs on the CPU with --device cpu, refuses to run without
it on a host with no card, and on a card every stage's checksum equals
the plain forms'.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from espflix_tpu_torch.tools import perf_stages as TP

try:
    import jax.numpy as jnp
    from espflix_tpu.tools import perf_stages as JP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JP = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 2
SMALL = (8, 2)          # mbw, mbh of the stages other than the fields
SALTS = (0, 1)
NAMES = list(TP.STAGE_KERNELS)


def _geom(name):
    return (22, 12) if name.startswith("fieldpair") else SMALL


@pytest.fixture(scope="module")
def jax_checksums():
    """{(geometry, name, salt): int} from the JAX tool's stages."""
    out = {}
    for geom in ((22, 12), SMALL):
        d = JP.build_inputs(LANES, *geom)
        stages = JP.make_stages(d, True)
        dd = {k: v for k, v in d.items() if k not in ("F", "geom")}
        for name in NAMES:
            if _geom(name) == geom:
                for salt in SALTS:
                    out[name, salt] = int(np.asarray(
                        stages[name](dd, jnp.int32(salt))))
    return out


@pytest.fixture(scope="module")
def port_stages():
    """{geometry: (inputs, stages)} of the port on the CPU."""
    out = {}
    for geom in ((22, 12), SMALL):
        d = TP.build_inputs(LANES, *geom, device="cpu")
        out[geom] = (d, TP.make_stages(d))
    return out


def test_inputs_match_jax_draws():
    j = JP.build_inputs(LANES, *SMALL)
    t = TP.build_inputs(LANES, *SMALL, device="cpu")
    assert set(j) == set(t)
    for k, v in j.items():
        if k in ("F", "geom"):
            assert t[k] == v
            continue
        for sub, jv in (v.items() if isinstance(v, dict) else [(None, v)]):
            a = np.asarray(jv)
            b = (t[k][sub] if sub else t[k]).numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, sub)


@pytest.mark.parametrize("name", NAMES)
def test_stage_checksum_matches_jax(name, jax_checksums, port_stages):
    d, stages = port_stages[_geom(name)]
    for salt in SALTS:
        got = stages[name](d, salt)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == jax_checksums[name, salt], (name, salt)


def test_cli_on_cpu(capsys):
    TP.main(["--device", "cpu", "--lanes", "2", "--iters", "1", "--reps",
             "2", "--stages", "idct_jnp,sbc,fieldpair", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["lanes"], line["iters"], line["backend"],
            line["device"]) == (2, 1, "cpu", "cpu")
    assert list(line["stages"]) == ["idct_jnp", "sbc", "fieldpair"]
    for st in line["stages"].values():
        assert set(st) == {"ms_min", "ms_med"}
        assert 0 < st["ms_min"] <= st["ms_med"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        TP.main(["--lanes", "2", "--stages", "sbc"])
    assert "no CUDA device" in str(e.value)


def test_residual_blocks_invert_the_plane_assembly():
    from espflix_tpu_torch.ops import mocomp as MC
    d = TP.build_inputs(LANES, *SMALL, device="cpu")
    res = TP.residual_blocks_flat(d["res_y"], d["res_u"], d["res_v"],
                                  *SMALL)
    assert res.shape == (LANES, SMALL[0] * SMALL[1] * 6, 64)
    for a, b in zip(MC.residual_planes_flat(res, *SMALL),
                    (d["res_y"], d["res_u"], d["res_v"])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_stages_on_card_match_plain():
    """Every stage's checksum on the card (the kernels) equals the
    stage on the CPU (the plain forms), 8 lanes at 352x192, salts 0 and
    5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dc = TP.build_inputs(8, device="cuda")
    dp = TP.build_inputs(8, device="cpu")
    card, plain = TP.make_stages(dc), TP.make_stages(dp)
    for name in NAMES:
        for salt in (0, 5):
            assert int(card[name](dc, salt)) == \
                int(plain[name](dp, salt)), (name, salt)
