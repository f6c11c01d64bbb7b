"""The port's play tool against the JAX tool's.

`python -m espflix_tpu_torch.tools.play --device cpu --field` for 3
frames of a generated service writes the same PGM files, byte for
byte, as `python -m espflix_tpu.tools.play --field`: the y/u/v planes
of the decoded frames and the synthesized composite field (with its
OSD progress bar) of each.
"""

import pytest
import torch

from tests.torch_fleet import python_feed  # noqa: F401 - fixture

torch.set_num_threads(1)


def test_play_field_pgms_match_jax(tmp_path, python_feed):  # noqa: F811
    from espflix_tpu.tools import play as JP
    from espflix_tpu.tools.indexer import make_service
    from espflix_tpu_torch.tools import play as TP

    svc = str(tmp_path / "svc")
    make_service(svc, ["title0"], seed=1, n_gops=1, gop=4)
    argv = ["--root", "file://" + svc, "--frames", "3", "--field"]
    assert JP.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert TP.main(argv + ["--out", str(tmp_path / "t"),
                           "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 3 * 4
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "t" / n).read_bytes(), n


def test_play_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from espflix_tpu.tools.indexer import make_service
    from espflix_tpu_torch.tools import play as TP

    svc = str(tmp_path / "svc")
    make_service(svc, ["title0"], seed=1, n_gops=1, gop=2)
    with pytest.raises((RuntimeError, AssertionError)):
        TP.main(["--root", "file://" + svc, "--frames", "1",
                 "--out", str(tmp_path / "o")])
