"""The port imports nothing of the JAX package, and its copies stay equal.

  * every module of espflix_tpu_torch/ and chip_smoke.py, read as an
    AST: no `import jax...` and no `import espflix_tpu` /
    `espflix_tpu.<...>` (espflix_tpu_torch itself is fine);
  * one subprocess imports every port module while a sys.meta_path
    finder refuses espflix_tpu and jax: each module imports;
  * the port's copies of the JAX package's jax-free modules (core/,
    audio/sbc.py, runtime/{events,checkpoint}.py, streaming/, video/,
    tools/) are pinned to their originals: the source, up to the
    import lines and the docstring that names the original; tables as
    arrays; the Ev members; and the encoder, muxer, indexer, SBC coder,
    demuxer, index, clock and OSD renderer giving identical output for
    a seed.
"""

import ast
import importlib
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "espflix_tpu_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
PORT_MODULES = sorted(
    p[:-3].replace("/", ".").removesuffix(".__init__")
    for p in PORT_FILES if p != "chip_smoke.py")

COPIES = ["core/vlc_tables.py", "core/sbc_tables.py", "core/bitio.py",
          "audio/sbc.py", "runtime/events.py", "runtime/checkpoint.py",
          "streaming/index.py", "streaming/streamer.py",
          "streaming/native.py", "streaming/ts.py", "video/clock.py",
          "video/render.py", "video/tables.py", "tools/indexer.py",
          "tools/ts_mux.py", "tools/mpeg1_encode.py",
          "tools/sbc_encode.py", "tools/content.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "espflix_tpu" or name.startswith("espflix_tpu."))


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_package_import_in_source(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, json, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "espflix_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
out = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except Exception as e:        # noqa: BLE001 - reported per module
        out[name] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def blocked_imports():
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, json.dumps(PORT_MODULES)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", PORT_MODULES)
def test_module_imports_with_jax_package_blocked(blocked_imports, module):
    assert blocked_imports[module] == "ok", blocked_imports[module]


# ---- the copies ----------------------------------------------------------

def _normalized(text: str) -> str:
    """Source without the lines a copy may change: imports, the
    docstring note naming the original, reference-checkout prefixes
    and the jax-only hbm_accounting of runtime/events.py."""
    text = text.split("\n\ndef hbm_accounting")[0]
    text = re.sub(r"\nCopied from espflix_tpu/\S+; tests/test_torch_"
                  r"isolation\.py\npins the copy to the original\.\n", "",
                  text)
    text = re.sub(r"/[a-z]+/reference/", "", text)
    text = text.replace(", and adds HBM accounting for the device\narrays "
                        "(the `mem()` analogue, prof.cpp:105-111).", ".")
    text = text.replace("espflix_tpu_torch.", "espflix_tpu.")
    return re.sub(r"\s+", " ", text).replace(' """', '"""').strip()


@pytest.mark.parametrize("path", COPIES)
def test_copy_source_matches_original(path):
    orig = (REPO / "espflix_tpu" / path).read_text()
    copy = (PORT / path).read_text()
    assert "pins the copy to the original" in copy
    assert _normalized(copy) == _normalized(orig)


def _pair(path):
    mod = path[:-3].replace("/", ".")
    return (importlib.import_module(f"espflix_tpu.{mod}"),
            importlib.import_module(f"espflix_tpu_torch.{mod}"))


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", ["core/vlc_tables.py", "core/sbc_tables.py",
                                  "video/tables.py", "streaming/index.py",
                                  "streaming/ts.py", "tools/ts_mux.py"])
def test_copy_constants_match(path):
    """Every module-level array, number, string and table is equal."""
    j, t = _pair(path)
    names = [n for n, v in vars(j).items() if not n.startswith("__")
             and isinstance(v, (np.ndarray, int, float, str, tuple, list,
                                dict))]
    assert names
    for n in names:
        assert _same(getattr(j, n), getattr(t, n)), n


def test_event_members_match():
    j, t = _pair("runtime/events.py")
    assert [(e.name, e.value) for e in j.Ev] == \
        [(e.name, e.value) for e in t.Ev]
    assert not hasattr(t, "hbm_accounting")
    dumps = []
    for m in (j, t):
        log = m.EventLog(capacity=3)
        for k in range(5):
            log.log(m.Ev.LANE_ERROR if k % 2 else m.Ev.SEEK, k, k * 7)
        dumps.append(([(e.ev.value, e.lane, e.value) for e in log.dump()],
                      log.counts()))
    assert dumps[0] == dumps[1] and len(dumps[0][0]) == 3


def _encoder_bytes(E, content, seed):
    rng = np.random.default_rng(seed)
    es = E.encode_es(E.random_script(rng, n_pictures=3, max_coeffs=12,
                                     width=96, height=64))
    return es + E.encode_es(content.realistic_gop_script(
        np.random.default_rng(seed), n_pictures=4))


def _behaviours():
    """name -> callable(package prefix) giving comparable output."""
    def mod(pkg, path):
        return importlib.import_module(f"{pkg}.{path}")

    def encoder(pkg):
        return _encoder_bytes(mod(pkg, "tools.mpeg1_encode"),
                              mod(pkg, "tools.content"), 11)

    def sbc_coder(pkg):
        enc = mod(pkg, "tools.sbc_encode")
        rng = np.random.default_rng(4)
        frames = [enc.random_frame(rng, mode=m, bitpool=bp)
                  for m in (0, 1, 0) for bp in (18, 28)]
        frames += enc.encode_pcm_mono(
            (np.sin(np.arange(512) / 9.0) * 9000).astype(np.int16))
        dec = mod(pkg, "audio.sbc").SbcDecoder()
        pcm = [dec.decode_frame(f) for f in frames]
        return frames, [None if r is None else r[0] for r in pcm]

    def muxer(pkg):
        mux = mod(pkg, "tools.ts_mux")
        es = encoder(pkg)
        return mux.mux_video_es(es), mux.mux_av(
            [(es[:500], 3000), (es[500:1400], 6000)],
            [(bytes(range(40)), 3000 + 240 * k) for k in range(9)])

    def indexer(pkg):
        idx = mod(pkg, "tools.indexer")
        rng = np.random.default_rng(2)
        return idx.make_title(rng, n_gops=2, gop=6)

    def demux(pkg):
        ts = mod(pkg, "streaming.ts")
        data = muxer(pkg)[1]
        out = []
        for fn in (ts.demux_ts, ts.demux_ts_numpy,
                   mod(pkg, "streaming.native").demux_ts):
            r = fn(data)
            out.append((r.video, r.video_pts_marks, r.sync_lost,
                        [(a.data, a.pts) for a in r.audio]))
        return out

    def index(pkg):
        ix = mod(pkg, "streaming.index")
        hdr = ix.IdxHdr.unpack(indexer(pkg)[3])
        return hdr.pack(), [hdr.pts2pts(p, s) for p in (0, 90000, 500000)
                            for s in (1, 15, -15)]

    def clock(pkg):
        c = mod(pkg, "video.clock").PresentationClock()
        out = []
        for k in range(12):
            c.tick()
            out.append(c.due_time(3003 * k + (9000 if k == 7 else 0)))
            if k == 5:
                c.pause(True)
            if k == 6:
                c.pause(False)
        return out, c.late_resets

    def renderer(pkg):
        r = mod(pkg, "video.render")
        osd = np.zeros((16, 80), np.uint8)
        r.show_time(osd, 3723, r.PLAY)
        return osd, (r.PAUSE, r.PLAY, r.FFWD, r.RWND)

    def bitio(pkg):
        b = mod(pkg, "core.bitio")
        w = b.BitWriter()
        for v, n in ((5, 3), (1023, 10), (0, 7), (1, 1)):
            w.put(v, n)
        w.start_code(0xB3)
        w.put_str("10110")
        w.align()
        data = w.tobytes()
        rd = b.BitReader(data)
        return data, [rd.get(n) for n in (3, 10, 7, 1)]

    def checkpoint(pkg):
        s = mod(pkg, "runtime.checkpoint").PositionStore()
        s.write("a-very-long-title-name-here", 90000)
        s.write("short", 7)
        return s.snapshot(), s.read("short"), s.read("missing")

    return {"encoder": encoder, "sbc_coder": sbc_coder, "muxer": muxer,
            "indexer": indexer, "demux": demux, "index": index,
            "clock": clock, "renderer": renderer, "bitio": bitio,
            "checkpoint": checkpoint}


BEHAVIOURS = _behaviours()


@pytest.mark.parametrize("name", list(BEHAVIOURS))
def test_copy_behaviour_matches(name):
    fn = BEHAVIOURS[name]
    assert _same(fn("espflix_tpu_torch"), fn("espflix_tpu"))


def test_streamer_reads_the_same_bytes(tmp_path):
    data = bytes(range(256)) * 40
    (tmp_path / "f.bin").write_bytes(data)
    url = "file://" + str(tmp_path / "f.bin")
    got = []
    for pkg in ("espflix_tpu", "espflix_tpu_torch"):
        s = importlib.import_module(f"{pkg}.streaming.streamer").Streamer()
        n = s.get(url, 100, 3000)
        got.append((n, s.read(1000), s.read(5000)))
        s.close()
    assert got[0] == got[1]


def test_service_generation_is_byte_identical(tmp_path):
    """The port's service generator (its indexer + SBC encoder copies)
    writes the same files as the JAX tool's for a seed."""
    from espflix_tpu.tools import serve_scenario as JSS
    from espflix_tpu_torch.tools import serve_scenario as TSS
    for SS, d in ((JSS, "j"), (TSS, "t")):
        SS.generate_service(str(tmp_path / d), ["a", "b"], seed=5,
                            n_gops=1)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 11
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
