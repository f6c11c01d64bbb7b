"""The pooled cell at a tiny size on the CPU: 4 lanes on 2 worker
processes, 2 titles, chunks of 2 ticks.

- a run reads correct, every count 0 (`workers` included), and
  `release` leaves no worker process running;
- a pool that joins its workers' shards in the wrong order (each tick's
  chain inputs from the last worker first) reads false on `pts` or
  `planes`.
"""

import copy

from espflix_tpu_torch.runtime import chunk_layout as CL
from espflix_tpu_torch.runtime import hostpool

from espbench.tests.tiny import run_tiny, tiny_cell

SEED = 2**31 + 13


def _tiny_pooled():
    cell = tiny_cell("ntsc.pooled")
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["host"]["workers"] = 2
    cell.mix = dict(cell.mix, lanes=4)
    return cell


def test_pooled_cell_is_correct_and_leaves_no_worker(monkeypatch):
    pools = []
    init = hostpool.HostPool.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        pools.append(self)
    monkeypatch.setattr(hostpool.HostPool, "__init__", keep)
    res = run_tiny(_tiny_pooled(), seed=SEED)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert "workers" in res["checks"]
    (pool,) = pools
    assert len(pool.procs) == 2
    assert all(p.poll() is not None for p in pool.procs)


def test_shards_joined_out_of_order_are_not_correct(monkeypatch):
    join = CL.join_workers
    monkeypatch.setattr(CL, "join_workers", lambda parts: join(parts[::-1]))
    res = run_tiny(_tiny_pooled(), seed=SEED)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["pts"]["value"] > 0 or checks["planes"]["value"] > 0
