"""ops/delta_sigma.modulate_spec and silence: the port against the JAX
package, and the PDM against the port's own C oracle binding
(tools/oracle.pdm_modulate).

modulate_spec is modulate under the JAX package's second name (K5 on a
card, modulate_torch here): two calls with the state carried, on
full-scale square waves and random PCM, equal the JAX speculative form
word for word and state for state, and each lane equals the golden
modulator run over the same samples with its state carried.  silence
equals the JAX words.  The `gpu` test holds K5 through modulate_spec
to the oracle at 1,024 lanes.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.ops import delta_sigma as TDS
from espflix_tpu_torch.tools import oracle

try:
    import jax.numpy as jnp
    from espflix_tpu.ops import delta_sigma as JDS
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JDS = None

torch.set_num_threads(1)


def _pcm(seed, N, T):
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (N, T)).astype(np.int16)
    square = np.where((np.arange(T) // 8) % 2, 32767, -32768)
    pcm[0] = square.astype(np.int16)
    pcm[1] = 0
    return pcm


def _two_calls(modulate, to, back, pcm, state):
    T = pcm.shape[1] // 2
    outs = []
    for k in range(2):
        w, state = modulate(to(pcm[:, k * T:(k + 1) * T]), state,
                            n_samples=T)
        outs.append(back(w))
    return np.concatenate(outs, axis=1), back(state)


@pytest.fixture(scope="module")
def spec_runs():
    pcm = _pcm(1, 4, 48)
    st0 = np.random.default_rng(2).integers(-2**20, 2**20, (4, 3)) \
        .astype(np.int32)
    st0[0] = 0
    port = _two_calls(TDS.modulate_spec, torch.from_numpy,
                      lambda t: t.numpy(), pcm, torch.from_numpy(st0))
    ref = _two_calls(JDS.modulate_spec, jnp.asarray, np.asarray, pcm,
                     jnp.asarray(st0))
    return pcm, st0, port, ref


def test_modulate_spec_matches_jax(spec_runs):
    _pcm_, _st0, (pw, ps), (jw, js) = spec_runs
    assert pw.dtype == jw.dtype and np.array_equal(pw, jw)
    assert ps.dtype == js.dtype and np.array_equal(ps, js)


def test_modulate_matches_oracle(spec_runs):
    """The golden modulator with the state carried across the two
    calls: each lane's words and final state."""
    pcm, st0, (pw, ps), _ref = spec_runs
    T = pcm.shape[1] // 2
    for i in range(len(pcm)):
        st = st0[i]
        words = []
        for k in range(2):
            w, st = oracle.pdm_modulate(pcm[i, k * T:(k + 1) * T], st)
            words.append(w)
        assert np.array_equal(pw[i], np.concatenate(words)), i
        assert np.array_equal(ps[i], st), i


def test_silence_matches_jax():
    t = TDS.silence(3, 40, "cpu")
    j = np.asarray(JDS.silence(3, 40))
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), j)
    assert (j == 0xAAAA).all()


@pytest.mark.gpu
def test_modulate_spec_on_card_matches_oracle():
    """K5 through modulate_spec at 1,024 lanes, two calls of 256 samples
    with the state carried: every 16th lane against the oracle, all
    lanes against modulate_torch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pcm = _pcm(3, 1024, 512)
    st0 = torch.zeros((1024, 3), dtype=torch.int32)
    before = TDS.launches
    cw, cs = _two_calls(TDS.modulate_spec, lambda a: torch.from_numpy(
        a.copy()).cuda(), lambda t: t.cpu().numpy(), pcm, st0.cuda())
    assert TDS.launches == before + 2
    lanes = slice(0, 1024, 16)
    pw, ps = _two_calls(TDS.modulate_torch, torch.from_numpy,
                        lambda t: t.numpy(), pcm[lanes], st0[lanes])
    assert np.array_equal(cw[lanes], pw) and np.array_equal(cs[lanes], ps)
    for i in range(0, 1024, 64):
        w, s = oracle.pdm_modulate(pcm[i])
        assert np.array_equal(cw[i], w) and np.array_equal(cs[i], s), i
