"""run_chunk_full under a 'streams' mesh: the port vs the JAX package.

The port's Fleet(output=True, mesh=make_mesh(devices=[cpu] * 2)) and
the JAX mesh fleet on 2 of the conftest's virtual devices run the same
one-title service (the recipe of test_mesh.py:195-249): 8 lanes on 2
shards, 2 ticks, lane 5 tapped -- planes, field_sum, pdm_sum, errors and
the taps (the masked per-shard taps summed) are equal, and the SBC and
PDM state end Sharded.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.parallel import mesh as TPM
from tests.torch_fleet import np_

torch.set_num_threads(1)


def test_full_chain_under_mesh_matches_jax(tmp_path):
    """Fleet.run_chunk_full on a 2-shard mesh vs the JAX mesh fleet: the
    sharded chain with the masked tap sum."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest's virtual devices")
    from espflix_tpu.parallel import mesh as JPM
    from espflix_tpu.runtime import player as JPL
    from espflix_tpu.runtime import scheduler as JSCH
    from espflix_tpu.tools.sbc_encode import random_frame
    from espflix_tpu_torch.runtime import player as TPL
    from espflix_tpu_torch.runtime import scheduler as TSCH
    from espflix_tpu_torch.tools.indexer import make_service as t_service

    arng = np.random.default_rng(5)
    audio = [(random_frame(arng, mode=0, bitpool=28), k * 240)
             for k in range(200)]
    t_service(str(tmp_path), ["one"], seed=5, n_gops=2, gop=3,
              audio_frames=audio)
    url = "file://" + str(tmp_path)
    n = 8

    def attach(fleet, PL):
        for i in range(n):
            s = PL.PlayerSession(url)
            assert s.init_service()
            s.nav(0)
            s.play_pause()
            fleet.attach(i, s)
        return fleet

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ESPFLIX_NATIVE_FEED", "0")
        jf = attach(JSCH.Fleet(n, words_per_lane=8192, parser="pallas",
                               output=True, mesh=JPM.make_mesh(2)), JPL)
        tmesh = TPM.make_mesh(devices=[torch.device("cpu")] * 2)
        tf = attach(TSCH.Fleet(n, words_per_lane=8192, output=True,
                               mesh=tmesh, device="cpu"), TPL)
        jr = jf.run_chunk_full(2, tap_lanes=(5,))
        tr = tf.run_chunk_full(2, tap_lanes=(5,))
    assert len(jr) == len(tr) == 2
    for a, b in zip(jr, tr):
        for key in ("field_sum", "pdm_sum", "errors", "tap_fields",
                    "tap_pdm", "video_lanes", "y", "u", "v"):
            x, y = np.asarray(getattr(a, key)), np_(getattr(b, key))
            assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert isinstance(tf.sbc_state, TPM.Sharded)
    assert isinstance(tf.output.pdm_state, TPM.Sharded)
    assert np.array_equal(TPM.unshard(tmesh, tf.output.pdm_state,
                                      TPM.LANES).numpy(),
                          np.asarray(jf.output.pdm_state))
    assert tr[-1].video_lanes.all()
