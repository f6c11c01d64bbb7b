"""The fleet under a 'streams' mesh on the device parser: the port vs
the JAX package.

A JAX Fleet(parser="device", mesh=make_mesh(2)) on the conftest's
virtual CPU devices and the port's Fleet(mesh=make_mesh(devices=[cpu]
* 2)) serve the same file:// service (tests/torch_fleet.py) from the
same random frames, parity and SBC history; four lanes with three
sessions, lane 1's first picture the corrupt one; two ticks with tick,
then one run_chunk of 2 (the sequential scan per shard; under a mesh
run_chunk runs tick by tick, as the JAX fleet's does).  Every
TickResult field, the final frames (joined), parity, SBC history, the
sessions and the event logs are equal.
"""

import numpy as np
import pytest
import torch

from espflix_tpu_torch.parallel import mesh as TPM
from tests.torch_fleet import (RESULT_KEYS, assert_carries_equal,
                               assert_results_equal, make_service,
                               python_feed, run_both, ticks_then_chunk)

torch.set_num_threads(1)

PARSERS = ("device",)


@pytest.fixture(scope="module")
def served(tmp_path_factory, python_feed):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest's virtual devices")
    url = make_service(tmp_path_factory, "svc_mesh_device")
    return {parser: run_both(url, ticks_then_chunk, n=4, lanes=(0, 1, 3),
                             corrupt_lane=1, seed=3, parser=parser,
                             shards=2)
            for parser in PARSERS}


@pytest.mark.parametrize("parser", PARSERS)
@pytest.mark.parametrize("key", RESULT_KEYS)
def test_mesh_fleet_results_match(served, parser, key):
    _jf, jr, _tf, tr = served[parser]
    assert_results_equal(jr, tr, key)


@pytest.mark.parametrize("parser", PARSERS)
def test_mesh_fleet_carries_match(served, parser):
    jf, _jr, tf, tr = served[parser]
    assert_carries_equal(jf, tf)
    assert isinstance(tf.frames["y"], TPM.Sharded)
    assert len(tf.frames["y"]) == 2
    assert isinstance(tr[0].y, np.ndarray)
    errs = np.stack([r.errors for r in tr])
    assert errs[:, 1].sum() == 1 and not errs[:, [0, 2, 3]].any()
