"""Composite field pair on the shared edge case (tools/composite_cases.py):
K4's plain form vs the JAX package on the CPU, K4 vs its plain form on
the card, and K4's chroma table.

  * composite_pallas.synthesize_field_pair_parts (interpret mode) and
    the port's synthesize_field_pair_parts_torch on the edge case (7
    lanes: every blend class, progress at the bar's ends, both
    parities, luma across the dither mask, every chroma value), NTSC
    and PAL: act, strip and chk exactly;
  * chroma_words(), the table K4 builds in shared memory, against the
    JAX package's chroma chain (composite._chroma_samples, which divides
    by 66 where the kernels multiply by 3972 >> 18) for all 256
    samples, and against the port's plain form's chroma words;
  * on the card (`gpu`): K4 against its plain form on the edge case, at
    lane counts that are and are not a multiple of its eight lanes a
    block.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import composite as TCO
from espflix_tpu_torch.tools import composite_cases as CC

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import composite as JCO
    from espflix_tpu.ops import composite_pallas as JCP
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JCO = JCP = None

torch.set_num_threads(1)

SEED = 31
OUTS = ("act", "strip", "chk")


def _case(n_lanes=CC.LANE_COUNTS[0]):
    return CC.composite_case(SEED, n_lanes)


def _args(case, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
            for k in CC.ARGS]


def _consts(pal, device="cpu"):
    tmpl, dith, _g = TCO._packed_consts(pal)
    return dict(tmpl=torch.from_numpy(tmpl).to(device),
                dither=torch.from_numpy(np.ascontiguousarray(dith))
                .to(device))


def test_case_covers_the_edges():
    c = _case()
    assert set(c["blend"]) == set(CC.BLENDS)
    assert set(c["progress"]) == set(CC.PROGRESS)
    assert set(c["parity"]) == {0, 1}
    assert set(CC.LUMA_EDGES) <= set(np.unique(c["y"]))
    for key in "uv":
        assert set(np.unique(c[key][:, :2])) == set(range(256))
        assert set(CC.CHROMA_EDGES) <= set(np.unique(c[key][:, 2:]))
    assert all(n % 8 for n in CC.LANE_COUNTS)


@pytest.fixture(scope="module")
def refs():
    c = _case()
    out = {}
    for pal in (False, True):
        j = JCP.synthesize_field_pair_parts(
            *[jnp.asarray(c[k]) for k in CC.ARGS], pal=pal, interpret=True)
        t = TCO.synthesize_field_pair_parts(*_args(c), pal=pal,
                                            **_consts(pal))
        out[pal] = ([np.asarray(a) for a in j], [a.numpy() for a in t])
    return out


@pytest.mark.parametrize("pal", [False, True], ids=["ntsc", "pal"])
@pytest.mark.parametrize("i,name", list(enumerate(OUTS)))
def test_plain_matches_pallas_on_edge_case(refs, pal, i, name):
    j, t = refs[pal]
    assert t[i].dtype == j[i].dtype and t[i].shape == j[i].shape, name
    assert np.array_equal(t[i], j[i]), name


@pytest.mark.parametrize("pal", [False, True], ids=["ntsc", "pal"])
def test_chroma_words_match_jax_chain(pal):
    """Every sample 0..255 sits in chroma rows 0 and 1 (canvas rows 0
    and 2, no V-switch), and every even one in rows 3 and 4 alike
    (canvas row 7 averages them: the V-switch on PAL): cxb of a u
    sample's (even, odd) pixel pair is word 0 of the table, cxa of a v
    sample's is word 0, or word 1 on a V-switch line."""
    words = TCO.chroma_words()
    assert words.dtype == np.uint32 and words.shape == (2, 256)
    samples = np.arange(256)
    c = np.zeros((1, 96, 176), np.uint8)
    c[0, 0, :128] = samples[:128]
    c[0, 1, :128] = samples[128:]
    c[0, 3:5, :128] = samples[::2]
    cxa, cxb = (np.asarray(a).astype(np.int64) & 0xFFFF for a in
                JCO._chroma_samples(jnp.asarray(c), jnp.asarray(c),
                                    pal=pal))

    def pairs(plane, row):
        return plane[0, row, 0::2] | plane[0, row, 1::2] << 16

    for row, s in ((0, samples[:128]), (2, samples[128:])):
        assert np.array_equal(pairs(cxb, row)[:128], words[0][s])
        assert np.array_equal(pairs(cxa, row)[:128], words[0][s])
    odd = samples[::2]
    assert np.array_equal(pairs(cxb, 7)[:128], words[0][odd])
    assert np.array_equal(pairs(cxa, 7)[:128], words[int(pal)][odd])
    assert np.array_equal(words[1], (words[0] >> 16) | (words[0] << 16))


def test_chroma_words_match_plain_chain():
    """The port's plain form computes the same words, sample by sample:
    one chroma row holding 0..255, even canvas rows (no V-switch)."""
    words = TCO.chroma_words()
    c = np.zeros((1, 96, 176), np.uint8)
    c[0, 0, :128] = np.arange(128)
    c[0, 1, :128] = np.arange(128, 256)
    # luma 0 and dither 0 make sa 0: sac = cxa and pbc = cxb
    y = torch.zeros(1, 192, 352, dtype=torch.uint8)
    args = [y, torch.from_numpy(c), torch.from_numpy(c),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 16, 80, dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32)]
    consts = _consts(False)
    consts["dither"] = torch.zeros_like(consts["dither"])
    act = TCO.synthesize_field_pair_parts_torch(*args, pal=False,
                                                **consts)[0]
    a = act[0, 0].numpy().astype(np.int64) & 0xFFFF
    sac, pbc = a & 0xFF, a >> 8
    for row, s in ((0, np.arange(128)), (2, np.arange(128, 256))):
        for plane in (sac, pbc):
            pair = plane[row, 0::2] | plane[row, 1::2] << 16
            assert np.array_equal(pair[:128], words[0][s])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pal", [False, True], ids=["ntsc", "pal"])
@pytest.mark.parametrize("lanes", CC.LANE_COUNTS + (16, 17))
def test_kernel_matches_plain_on_edge_case(pal, lanes):
    dev = _card()
    c = _case(lanes)
    got = TCO.synthesize_field_pair_parts(*_args(c, dev), pal=pal,
                                          **_consts(pal, dev))
    ref = TCO.synthesize_field_pair_parts_torch(*_args(c), pal=pal,
                                                **_consts(pal))
    for name, a, b in zip(OUTS, got, ref):
        assert torch.equal(a.cpu(), b), name
