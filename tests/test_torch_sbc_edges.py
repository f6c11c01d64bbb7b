"""SBC decode edges: the port's plain form vs JAX, and K6 vs the plain form.

The inputs K6 (csrc/sbc.cu) must copy bit for bit: a valid frame whose
bitpool byte is 250 (the allocation reaches its 48-trip cap and the
unpack runs past the buffer), SNR allocation, all-zero scale factors,
frames of the other channel count, broken sync words, every sampling
frequency, mixed bitpools padded to one frame length, partial and empty
n_valid, an inactive lane and a random carried history; and frames of
random words with no zero padding (word_case), where extract_bits' rules
past the buffer -- the first word past it reads 0, the second word's
index clamps to the last -- decide the fields.  The CPU tests hold
models/sbc.decode_frames_batched_torch to the JAX decode_frames_batched
on them, exactly, over two calls, and check K6's IQUANT reciprocals
(ops/sbc_ops.iquant_reciprocals); the `gpu` tests hold K6 to the plain
form on the card.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.models import sbc as TS
from espflix_tpu_torch.ops import sbc_ops
from espflix_tpu_torch.tools.sbc_encode import random_frame

try:
    import jax.numpy as jnp
    from espflix_tpu.models import sbc as JS
except ImportError:     # the card's machine has no jax: gpu tests only
    jnp = JS = None

torch.set_num_threads(1)


def edge_case(seed: int, N: int, F: int, channels: int):
    """(words uint32[N, F, W], n_valid int32[N], active bool[N], hist
    int32[N, 2, 10, 16]) holding every edge above; N >= 4, F >= 4."""
    rng = np.random.default_rng(seed)
    mode = 0 if channels == 1 else 2
    other = 2 if channels == 1 else 0
    frames = [[random_frame(rng, mode=mode,
                            bitpool=int(rng.integers(2, 40)),
                            allocation=int(rng.random() < 0.3))
               for _ in range(F)] for _ in range(N)]
    frames[1][0] = random_frame(rng, mode=other, bitpool=8)
    frames[2][1] = random_frame(rng, mode=mode, bitpool=60, allocation=1)
    L = max(len(f) for lane in frames for f in lane)
    fr = np.zeros((N, F, L), np.uint8)
    for i, lane in enumerate(frames):
        for k, f in enumerate(lane):
            fr[i, k, :len(f)] = np.frombuffer(f, np.uint8)
    freq = rng.integers(0, 4, (N, F)).astype(np.uint8)
    fr[:, :, 1] = (fr[:, :, 1] & 0x3F) | (freq << 6)
    fr[0, 1, 2] = 250                        # bitpool past the buffer
    fr[0, 2, 4:4 + 4 * channels] = 0         # all-zero scale factors
    fr[3, 3, 0] = 0x00                       # broken sync word
    fr[2, 2, 1] ^= 0x30                      # 4 blocks: error frame
    words = TS.frames_to_words(fr)
    n_valid = rng.integers(0, F + 1, N).astype(np.int32)
    n_valid[0], n_valid[1], n_valid[N - 1] = F, F, 0
    active = np.ones(N, bool)
    active[N - 2] = False
    hist = rng.integers(-30000, 30000, (N, 2, 10, 16)).astype(np.int32)
    return words, n_valid, active, hist


def word_case(seed: int, N: int, F: int, W: int, channels: int):
    """(words uint32[N, F, W], n_valid, active, hist): frames of random
    words under a valid header, bitpools 2, 20, 64 and 250, so that
    the unpack runs past a buffer whose last word is not 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (N, F, W), dtype=np.uint64) \
        .astype(np.uint32)
    mode = 0 if channels == 1 else rng.integers(1, 3, (N, F))
    b1 = (rng.integers(0, 4, (N, F)) << 6) | (3 << 4) | (mode << 2) \
        | (rng.integers(0, 2, (N, F)) << 1) | 1
    bitpool = rng.choice([2, 20, 64, 250], (N, F))
    words[:, :, 0] = (0x9C << 24) | (b1 << 16) | (bitpool << 8) \
        | rng.integers(0, 256, (N, F))
    hist = rng.integers(-30000, 30000, (N, 2, 10, 16)).astype(np.int32)
    return (words, np.full(N, F, np.int32), np.ones(N, bool), hist)


def _plain_call(words, hist, n_valid, active, F, channels):
    return TS.decode_frames_batched_torch(
        torch.from_numpy(words.view(np.int32)), hist,
        active=torch.from_numpy(active), n_valid=torch.from_numpy(n_valid),
        n_frames=F, channels=channels)


@pytest.mark.parametrize("channels", [1, 2])
def test_sbc_random_words_match_jax(channels):
    N, F, W = 6, 4, 7
    words, n_valid, active, hist = word_case(50 + channels, N, F, W,
                                             channels)
    jp, jh, je, jb = JS.decode_frames_batched(
        jnp.asarray(words), jnp.asarray(hist), active=jnp.asarray(active),
        n_valid=jnp.asarray(n_valid), n_frames=F, channels=channels)
    got = _plain_call(words, torch.from_numpy(hist), n_valid, active, F,
                      channels)
    for a, b in zip(got, (jp, jh, je, jb)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # fields past the buffer: frame_bits beyond the words' bits
    assert (got[3] > 32 * W).any() and not got[2].any()


def test_iquant_reciprocals_divide_exactly():
    """K6 divides by each IQUANT divisor d = max(2^level - 1, 1) as
    ((a << 2) * m) >> (32 + sh) for numerators a < 2^30: the
    Granlund-Montgomery condition in Python integers, then the
    multiply-shift against // in numpy at the boundary numerators."""
    recips = sbc_ops.iquant_reciprocals()
    assert len(recips) == sbc_ops.IQUANT_LEVELS == 17
    top = (1 << sbc_ops.NUMERATOR_BITS) - 1
    for level, (m, sh) in enumerate(recips):
        d = max((1 << level) - 1, 1)
        k = sbc_ops.NUMERATOR_BITS + sh
        e = m * d - (1 << k)
        assert 0 <= e and e * top < (1 << k) and 0 < m < (1 << 31), level
        ks = np.array([1, 2, 3, top // d - 1, top // d], np.uint64)
        a = np.unique(np.concatenate([
            [0, d - 1, d, top], ks * d - 1, ks * d])).astype(np.uint64)
        a = a[a <= top]
        got = ((a << np.uint64(2)) * np.uint64(m)) >> np.uint64(32 + sh)
        assert np.array_equal(got, a // np.uint64(d)), level
    assert sbc_ops.device_table("IQUANT_RECIP", "cpu").tolist() == \
        [list(r) for r in recips]


@pytest.mark.parametrize("channels", [1, 2])
def test_sbc_edges_match_jax(channels):
    N, F = 6, 5
    words, n_valid, active, hist0 = edge_case(7 + channels, N, F, channels)
    jh = jnp.asarray(hist0)
    th = torch.from_numpy(hist0.copy())
    for call in range(2):
        w = words if call == 0 else np.roll(words, 1, axis=1)
        jp, jh, je, jb = JS.decode_frames_batched(
            jnp.asarray(w), jh, active=jnp.asarray(active),
            n_valid=jnp.asarray(n_valid), n_frames=F, channels=channels)
        tp, th, te, tb = _plain_call(w, th, n_valid, active, F, channels)
        for name, a, b in (("pcm", tp, jp), ("hist", th, jh),
                           ("error", te, je), ("frame_bits", tb, jb)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), (call, name)
        assert te.any() and (tp != 0).any()
        # the 250 bitpool frame decodes as a valid frame past the buffer
        assert int(tb[0, 1 + call]) > 32 * words.shape[2]
        assert not te[0, 1 + call]


def test_cpu_call_launches_nothing_and_other_devices_raise():
    words, n_valid, active, hist = edge_case(3, 4, 4, 1)
    before = TS.launches
    out = TS.decode_frames_batched(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(hist),
        active=torch.from_numpy(active), n_valid=torch.from_numpy(n_valid),
        n_frames=4)
    ref = _plain_call(words, torch.from_numpy(hist), n_valid, active, 4, 1)
    assert TS.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TS.decode_frames_batched(
            torch.empty((4, 4, words.shape[2]), dtype=torch.int32,
                        device="meta"),
            torch.empty((4, 2, 10, 16), dtype=torch.int32, device="meta"),
            n_frames=4)


def test_device_tables_cached_and_k6_shared_memory():
    a = sbc_ops.device_table("SYN_8", "cpu")
    assert sbc_ops.device_table("SYN_8", torch.device("cpu")) is a
    assert a.dtype == torch.int32 and tuple(a.shape) == (16, 8)
    assert tuple(sbc_ops.device_table("OFFSET_8", "cpu").shape) == (4, 8)
    assert TS.shared_bytes(13, 1) == 21_324
    assert TS.shared_bytes(13, 2) < 48 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2])
def test_sbc_kernel_matches_plain_on_card(channels):
    """K6 against decode_frames_batched_torch on the card: the edge cases
    (two calls, carried random hist), without the optional masks, and
    the chain's 1,024 lanes x 13 frames; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    cases = [(edge_case(11 + channels, 8, 6, channels), 6),
             (edge_case(21 + channels, 1024, 13, channels), 13)]
    for (words, n_valid, active, hist), F in cases:
        w = torch.from_numpy(words.view(np.int32)).to(dev)
        hk = hp = torch.from_numpy(hist).to(dev)
        act = torch.from_numpy(active).to(dev)
        nv = torch.from_numpy(n_valid).to(dev)
        for call in range(2):
            wc = w if call == 0 else w.roll(1, dims=1).contiguous()
            before = TS.launches
            got = TS.decode_frames_batched(wc, hk, act, nv, n_frames=F,
                                           channels=channels)
            assert TS.launches == before + 1
            ref = TS.decode_frames_batched_torch(wc, hp, act, nv, n_frames=F,
                                                 channels=channels)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype and torch.equal(a, b), call
            hk, hp = got[1], ref[1]
        got = TS.decode_frames_batched(w, hk, n_frames=F, channels=channels)
        ref = TS.decode_frames_batched_torch(w, hk, n_frames=F,
                                             channels=channels)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2])
def test_sbc_kernel_random_words_on_card(channels):
    """K6 against the plain form on word_case's frames (fields past a
    buffer whose last word is not 0), 1,024 lanes, two carried calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    words, n_valid, active, hist = word_case(60 + channels, 1024, 5, 7,
                                             channels)
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    hk = hp = torch.from_numpy(hist).to(dev)
    act, nv = (torch.from_numpy(a).to(dev) for a in (active, n_valid))
    for call in range(2):
        wc = w if call == 0 else w.roll(1, dims=1).contiguous()
        got = TS.decode_frames_batched(wc, hk, act, nv, n_frames=5,
                                       channels=channels)
        ref = TS.decode_frames_batched_torch(wc, hp, act, nv, n_frames=5,
                                             channels=channels)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), call
        hk, hp = got[1], ref[1]
