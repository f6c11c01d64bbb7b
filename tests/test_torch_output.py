"""The port's per-field output path against the JAX OutputStage.

OutputStage.synthesize (K4's plain form on the CPU: field 0 of the
parts pair laid into the field's template, after the flip animation's
scroll blit) and OutputStage.modulate (beep substitution, K5's plain
form, starved lanes) on the same seeded numpy inputs as the JAX stage
(C.synthesize_field / synthesize_field_scrolled, DS.modulate): every
field, every PDM word and every carried state equal, across OSD, a fade
running out, every blend class, progress at the bar's ends, both slide
directions from the last synthesized planes (start_slide(prev=None)),
NTSC and PAL, beep, starved lanes and carried PDM state; and once from
runtime/output.stage_from_numpy of a JAX stage picked up mid-slide and
mid-beep.
"""

import numpy as np
import pytest
import torch

from espflix_tpu.runtime import output as JO
from espflix_tpu_torch.runtime import output as TO

torch.set_num_threads(1)

N = 3


def planes(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 192, 352)).astype(np.uint8),
            rng.integers(0, 256, (n, 96, 176)).astype(np.uint8),
            rng.integers(0, 256, (n, 96, 176)).astype(np.uint8))


STATE = ("osd", "blend", "progress", "frame_counter", "last_seconds",
         "beep_frames", "animate_index", "hscroll")


def same_state(j, t):
    for k in STATE:
        assert np.array_equal(np.asarray(getattr(j, k)),
                              getattr(t, k)), k
    assert np.array_equal(np.asarray(j.pdm_state), t.pdm_state.numpy())
    for k in ("_slide", "_last"):
        a, b = getattr(j, k), getattr(t, k)
        assert (a is None) == (b is None), k
        if a is not None:
            for p, q in zip(a, b):
                q = q.numpy() if isinstance(q, torch.Tensor) else q
                assert np.array_equal(np.asarray(p), np.asarray(q)), k


def both(pal=False):
    return JO.OutputStage(N, pal=pal), TO.OutputStage(N, pal=pal,
                                                      device="cpu")


def osd_setup(st):
    # lane 0: time readout, a fade of 3 fields that runs out mid-run;
    # lane 1: always shown (-1), the bar full (240 units);
    # lane 2: shown at full scale (>= 32), the bar empty
    st.update_progress(0, 90000 * 65, 90000 * 100)
    st.show_progress(0, t=3)
    st.update_progress(1, 90000 * 100, 90000 * 100, TO.FFWD)
    st.show_progress(1, t=-1)
    st.update_progress(2, 0, 90000 * 100)
    st.show_progress(2, t=40)


@pytest.mark.parametrize("pal", [False, True], ids=["ntsc", "pal"])
def test_synthesize_matches_across_osd_fades_and_slides(pal):
    js, ts = both(pal)
    for st in (js, ts):
        osd_setup(st)
        st.start_slide(0, 3)          # no planes yet: does nothing
    same_state(js, ts)
    for k in range(7):
        y, u, v = planes(k)
        if k == 2:
            for st in (js, ts):
                # slides from the last synthesized planes, one lane in
                # each direction; lane 2's OSD hidden (blend 0)
                st.start_slide(1, 3)
                st.start_slide(2, 2)
                st.hide_progress(2)
        fj = np.asarray(js.synthesize(y, u, v))
        ft = ts.synthesize(y, u, v)
        assert ft.dtype == torch.uint8 and ft.device.type == "cpu"
        assert np.array_equal(fj, ft.numpy()), f"field {k}"
        same_state(js, ts)
    # the slides ran on the scrolled branch
    assert ts.hscroll[1] > 0 and ts.hscroll[2] < 0


def test_start_slide_copies_only_the_lane_from_tensors():
    """prev as tensors (the planes a CUDA caller passes): the same
    snapshots as numpy prev."""
    js, ts = both()
    y, u, v = planes(9)
    js.start_slide(1, 2, prev=(y, u, v))
    ts.start_slide(1, 2, prev=tuple(torch.from_numpy(p) for p in (y, u, v)))
    same_state(js, ts)


def test_modulate_matches_beep_starved_and_carried_state():
    js, ts = both()
    rng = np.random.default_rng(4)
    js.beep(0)
    ts.beep(0)
    # T = 128 (one beep frame), 256 (two), then an odd count: the beep
    # runs out mid-run on lane 0; lane 2 starves on the second call
    for k, T in enumerate((128, 256, 77, 128)):
        pcm = rng.integers(-32768, 32768, (N, T)).astype(np.int16)
        starved = None
        if k == 1:
            starved = np.array([False, False, True])
        elif k == 3:
            starved = np.array([True, False, False])
        wj = np.asarray(js.modulate(pcm, starved))
        wt = ts.modulate(pcm, starved)
        assert wt.dtype == torch.int32 and wt.shape == (N, 2 * T)
        assert np.array_equal(wj, wt.numpy()), f"call {k}"
        same_state(js, ts)
    assert ts.beep_frames[0] == 0


def test_stage_from_numpy_continues_mid_slide_and_beep():
    """A JAX stage picked up in the middle of a slide and a beep by
    stage_from_numpy, then both run side by side."""
    js = JO.OutputStage(N)
    osd_setup(js)
    js.synthesize(*planes(20))
    js.start_slide(0, 2)
    js.start_slide(2, 3)
    js.beep(1)
    js.synthesize(*planes(21))
    js.modulate(np.zeros((N, 128), np.int16))
    fields = {k: np.asarray(getattr(js, k))
              for k in STATE + ("pdm_state",)}
    fields["_slide"] = js._slide
    fields["_last"] = js._last
    ts = TO.stage_from_numpy(fields, "cpu")
    same_state(js, ts)
    assert ts.hscroll[0] != 0 and ts.beep_frames[1] > 0
    rng = np.random.default_rng(5)
    for k in range(3):
        y, u, v = planes(22 + k)
        assert np.array_equal(np.asarray(js.synthesize(y, u, v)),
                              ts.synthesize(y, u, v).numpy())
        pcm = rng.integers(-9000, 9000, (N, 128)).astype(np.int16)
        assert np.array_equal(np.asarray(js.modulate(pcm)),
                              ts.modulate(pcm).numpy())
        same_state(js, ts)


def test_output_stage_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TO.OutputStage(1)
