"""The port's FetchPool (streaming/fetch_pool.py, a copy of the JAX
package's): pooled prefetch of file streams with bounded queues and EOS
semantics, as tests/test_fetch_pool.py holds the original; the bytes
equal the file's and the JAX pool's."""

import os

from espflix_tpu.streaming.fetch_pool import FetchPool as JFetchPool
from espflix_tpu_torch.streaming.fetch_pool import FetchPool
from espflix_tpu_torch.tools.indexer import make_service


def _drain(pool, key):
    out = b""
    for _ in range(100000):
        c = pool.poll(key)
        if c is None:
            continue
        if c == b"":
            break
        out += c
    return out


def test_fetch_pool_file_streams(tmp_path):
    root = str(tmp_path / "svc")
    make_service(root, ["t"], seed=5, n_gops=1, gop=4)
    path = os.path.join(root, "media/t/video.ts")
    with open(path, "rb") as f:
        want = f.read()
    got = []
    for cls in (FetchPool, JFetchPool):
        pool = cls(workers=4)
        assert pool.open(1, "file://" + path)
        assert pool.open(2, "file://" + path, offset=188 * 4)
        got.append((_drain(pool, 1), _drain(pool, 2)))
        pool.close(1)
        pool.shutdown()
    assert got[0] == got[1] == (want, want[188 * 4:])


def test_fetch_pool_missing_file():
    pool = FetchPool(workers=1)
    assert not pool.open(1, "file:///nonexistent/xyz.ts")
    assert pool.poll(1) is None
    pool.shutdown()
