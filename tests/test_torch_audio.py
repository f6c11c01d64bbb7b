"""SBC decode, delta-sigma PDM and the chain's audio selects: port vs JAX.

Same numpy inputs through models/sbc.decode_frames_batched and
ops/delta_sigma.modulate of both packages: two calls with carried
state, error frames, partial tails (n_valid), inactive lanes, mono and
two-channel frames; the PDM (K5's plain form modulate_torch) at the
chain's tick lengths with full-scale square waves and wrapping states;
and the beep / starve / silence selects of the chain (chain.py:126-137)
around the PDM.  Exact equality throughout.  The JAX side of the PDM
is the package's own plain reference DS.modulate: modulate_pallas in
interpret mode loops XLA's CPU simplifier for tens of minutes
(tests/test_pdm_pallas.py).  The `gpu` test holds K5 against
modulate_torch on the card.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.tools.sbc_encode import random_frame
from espflix_tpu_torch.models import sbc as TS
from espflix_tpu_torch.ops import delta_sigma as TDS
from espflix_tpu_torch.runtime import chain as TCH

try:
    import jax.numpy as jnp
    from espflix_tpu.models import sbc as JS
    from espflix_tpu.ops import delta_sigma as JDS
    from espflix_tpu.runtime import chain as JCH
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JS = JDS = JCH = None

torch.set_num_threads(1)


def _frames(seed, N, F, mode, bitpool):
    rng = np.random.default_rng(seed)
    fr = np.stack([np.stack([np.frombuffer(
        random_frame(rng, mode=mode, bitpool=bitpool), np.uint8)
        for _ in range(F)]) for _ in range(N)])
    return fr


def _sbc_case(seed, channels):
    N, F = 4, 5
    mode = 0 if channels == 1 else 2
    fr = _frames(seed, N, F, mode, 28 if channels == 1 else 40)
    fr[1, 2, 0] = 0x00              # broken syncword: error frame
    fr[3, 0, 1] ^= 0x0C             # header mode flips: error frame
    words = JS.frames_to_words(fr)
    n_valid = np.array([F, 3, F, 0], np.int32)   # partial tails, empty
    active = np.array([True, True, False, True])
    return words, n_valid, active, F


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("seed", [1, 2])
def test_sbc_two_calls_carried_state(channels, seed):
    words, n_valid, active, F = _sbc_case(seed, channels)
    rng = np.random.default_rng(seed)
    hist0 = rng.integers(-2000, 2000, (4, 2, 10, 16)).astype(np.int32)
    jh = jnp.asarray(hist0)
    th = torch.from_numpy(hist0.copy())
    seen_err = False
    for call in range(2):
        w = words if call == 0 else words[::-1].copy()
        jp, jh, je, jb = JS.decode_frames_batched(
            jnp.asarray(w), jh, active=jnp.asarray(active),
            n_valid=jnp.asarray(n_valid), n_frames=F, channels=channels)
        tp, th, te, tb = TS.decode_frames_batched(
            torch.from_numpy(w.view(np.int32)), th,
            active=torch.from_numpy(active),
            n_valid=torch.from_numpy(n_valid), n_frames=F,
            channels=channels)
        for name, a, b in (("pcm", tp, jp), ("hist", th, jh),
                           ("error", te, je), ("frame_bits", tb, jb)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), (call, name)
        seen_err |= bool(np.asarray(je).any())
    assert seen_err                             # error frames reached


def test_sbc_without_masks():
    words, _nv, _act, F = _sbc_case(3, 1)
    jp, jh, je, _ = JS.decode_frames_batched(
        jnp.asarray(words), JS.init_state(4), n_frames=F)
    tp, th, te, _ = TS.decode_frames_batched(
        torch.from_numpy(words.view(np.int32)), TS.init_state(4, "cpu"),
        n_frames=F)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("seed", [1, 2])
def test_pdm_two_calls_carried_state(seed):
    rng = np.random.default_rng(seed)
    N, T = 3, 96
    st = rng.integers(-50000, 50000, (N, 3)).astype(np.int32)
    js, ts = jnp.asarray(st), torch.from_numpy(st.copy())
    for call in range(2):
        pcm = rng.integers(-32768, 32768, (N, T)).astype(np.int16)
        pcm[0] = 0
        pcm[1, :8] = [32767, -32768] * 4          # full-scale swings
        jw, js = JDS.modulate(jnp.asarray(pcm), js, n_samples=T)
        tw, ts = TDS.modulate(torch.from_numpy(pcm), ts, n_samples=T)
        assert tw.dtype == torch.int32 and ts.dtype == torch.int32
        assert np.array_equal(tw.numpy(), np.asarray(jw)), call
        assert np.array_equal(ts.numpy(), np.asarray(js)), call


def _pdm_case(seed, N, S):
    """PCM for one call: square waves at full scale (+-32767, several
    periods), random full-range samples, silence and a DC rail."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (N, S)).astype(np.int16)
    t = np.arange(S)
    for k in range(0, N, 4):
        period = 2 << (k % 7)
        pcm[k] = np.where((t // period) & 1, 32767, -32767)
    pcm[1] = 0
    pcm[2] = 32767
    return pcm


@pytest.mark.parametrize("N,S", [(8, 1664), (16, 3328)],
                         ids=["mono_tick", "stereo_tick"])
def test_pdm_tick_two_calls_wrapping_state(N, S):
    """The chain's tick lengths (13 SBC frames: 1,664 mono or 3,328
    stereo samples), two calls with the state carried, starting from
    random states in +-2e6 (the int32 adds wrap)."""
    rng = np.random.default_rng(N)
    st = rng.integers(-2_000_000, 2_000_000, (N, 3)).astype(np.int32)
    js, ts = jnp.asarray(st), torch.from_numpy(st.copy())
    for call in range(2):
        pcm = _pdm_case(10 * N + call, N, S)
        jw, js = JDS.modulate(jnp.asarray(pcm), js, n_samples=S)
        tw, ts = TDS.modulate_torch(torch.from_numpy(pcm), ts, n_samples=S)
        assert tw.shape == (N, 2 * S) and tw.dtype == torch.int32
        assert np.array_equal(tw.numpy(), np.asarray(jw)), call
        assert np.array_equal(ts.numpy(), np.asarray(js)), call
    assert ((tw.numpy() >= 0) & (tw.numpy() < 1 << 16)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", [(5, 7), (40, 100), (1024, 1664)])
def test_kernel_matches_plain_on_card(N, S):
    """K5 (csrc/pdm.cu) against modulate_torch on the card, with lane
    and sample counts off the kernel's 32-lane / 32-sample tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(S)
    pcm = torch.from_numpy(_pdm_case(S, N, S)).cuda()
    st = torch.from_numpy(rng.integers(-2_000_000, 2_000_000, (N, 3))
                          .astype(np.int32)).cuda()
    before = TDS.launches
    got = TDS.modulate(pcm, st, n_samples=S)
    ref = TDS.modulate_torch(pcm, st, n_samples=S)
    assert TDS.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _jax_audio_out(pcm, ds, beep_left, aud_act, starved, S):
    """chain.py:129-137 as written in the JAX chain body."""
    wave = jnp.asarray(JCH.beep_wave(S))
    pcm = jnp.asarray(pcm)[:, :S]
    t = jnp.arange(S, dtype=jnp.int32)[None, :]
    beeping = t < (jnp.asarray(beep_left) * 128)[:, None]
    pcm = jnp.where(beeping, wave[None, :], pcm)
    pdm, ds2 = JDS.modulate(pcm, jnp.asarray(ds), n_samples=S)
    silent = jnp.asarray(starved) | ~(jnp.asarray(aud_act)
                                      | (jnp.asarray(beep_left) > 0))
    pdm = jnp.where(silent[:, None], JDS.SILENCE_WORD, pdm)
    return pdm, jnp.where(silent[:, None], jnp.asarray(ds), ds2)


def test_beep_starve_silence_selects():
    """Lanes: playing, beeping, starved, idle, idle-but-beeping: beeps
    override PCM, starved and idle lanes emit 0xAAAA with their
    modulator state untouched."""
    rng = np.random.default_rng(4)
    N, S = 5, 256
    pcm = rng.integers(-20000, 20000, (N, S + 128)).astype(np.int16)
    ds = rng.integers(-9000, 9000, (N, 3)).astype(np.int32)
    beep_left = np.array([0, 1, 2, 0, 1], np.int32)
    aud_act = np.array([True, True, True, False, False])
    starved = np.array([False, False, True, False, False])
    jp, jd = _jax_audio_out(pcm, ds, beep_left, aud_act, starved, S)
    tp, td = TCH.audio_out(
        torch.from_numpy(pcm), torch.from_numpy(ds.copy()),
        torch.from_numpy(beep_left), torch.from_numpy(aud_act),
        torch.from_numpy(starved), torch.from_numpy(TCH.beep_wave(S)))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert (tp.numpy()[[2, 3]] == TDS.SILENCE_WORD).all()
    assert np.array_equal(td.numpy()[[2, 3]], ds[[2, 3]])
