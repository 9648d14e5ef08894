"""RecordIO, the native layer and im2rec of mxnet_tpu_torch against the JAX
package.

* ``recordio``: files written by one package are the other's byte for
  byte (``.rec`` and ``.idx``), chunk chains included, and each package
  reads the other's; IRHeader packing of one and several labels;
  an indexed reader pickles, and worker threads share it.
* ``lib``: the port builds its own copy of the C++ (``native/``, equal
  to ``src/`` file for file) into ``build/torch_native/``; a failed
  build keeps its error and leaves no file, a library that does not
  load is rebuilt; the native writer writes the Python writer's bytes,
  the native readers read them; the engine's read/write ordering; fork
  safety; the knobs.
* ``tools/im2rec.py``: the port's ``.lst``, ``.rec`` and ``.idx`` are the
  JAX tool's byte for byte, for a shuffled recursive list, a resized
  and centre-cropped pack, a PNG pack and ``--pack-label``.
"""
import importlib.util
import os
import pickle
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import lib, recordio as trio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import im2rec as tim2rec

REPO = Path(__file__).resolve().parents[1]


def _records(n=9, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.bytes(int(rs.randint(0, 70))) for _ in range(n)]


def _write(mod, prefix, recs, max_chunk=None):
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    if max_chunk:
        w._max_chunk = max_chunk
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()


@pytest.mark.parametrize("max_chunk", [None, 16])
def test_files_are_the_jax_packages_byte_for_byte(tmp_path, max_chunk):
    recs = _records() + [b"\x0a\x23\xd7\x3e" * 9]  # the magic in a record
    _write(jrio, str(tmp_path / "j"), recs, max_chunk)
    _write(trio, str(tmp_path / "t"), recs, max_chunk)
    for ext in (".rec", ".idx"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    for writer, reader in ((jrio, trio), (trio, jrio)):
        p = str(tmp_path / ("j" if writer is jrio else "t"))
        r = reader.MXIndexedRecordIO(p + ".idx", p + ".rec", "r")
        assert [r.read_idx(k) for k in reversed(r.keys)] == recs[::-1]
        r.close()
        seq = reader.MXRecordIO(p + ".rec", "r")
        assert [seq.read() for _ in recs] == recs and seq.read() is None


def test_irheader_pack_unpack_as_the_jax_package():
    for label in (3.0, [1.0, 2.5, -4.0], np.arange(7, dtype=np.float32)):
        h = (0, label, 11, 2)
        s = trio.pack(trio.IRHeader(*h), b"payload")
        assert s == jrio.pack(jrio.IRHeader(*h), b"payload")
        th, tp = trio.unpack(s)
        jh, jp = jrio.unpack(s)
        assert tp == jp == b"payload"
        assert th.flag == jh.flag and th.id == 11 and th.id2 == 2
        np.testing.assert_array_equal(th.label, jh.label)


def test_pack_img_round_trip():
    img = np.random.RandomState(0).randint(0, 255, (12, 10, 3), np.uint8)
    s = trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img, img_fmt=".png")
    assert s == jrio.pack_img(jrio.IRHeader(0, 1.0, 0, 0), img,
                              img_fmt=".png")
    h, got = trio.unpack_img(s)
    assert h.label == 1.0
    np.testing.assert_array_equal(got, img)


def test_truncated_and_corrupt_records_raise(tmp_path):
    p = tmp_path / "x.rec"
    w = trio.MXRecordIO(str(p), "w")
    w.write(b"abcdefgh")
    w.close()
    p.write_bytes(p.read_bytes()[:-6])
    with pytest.raises(MXNetError, match="truncated"):
        trio.MXRecordIO(str(p), "r").read()
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(MXNetError, match="magic"):
        trio.MXRecordIO(str(p), "r").read()
    with pytest.raises(MXNetError, match="flag"):
        trio.MXRecordIO(str(p), "a")


def test_indexed_reader_pickles_and_threads_share_it(tmp_path):
    recs = _records(64, seed=1)
    _write(trio, str(tmp_path / "d"), recs)
    r = trio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                               str(tmp_path / "d.rec"), "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.keys == r.keys and r2.read_idx(5) == recs[5]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(r.read_idx, list(range(64)) * 8))
    finally:
        sys.setswitchinterval(old)
    assert got == recs * 8


# ---------------------------------------------------------------------------
# the native layer
# ---------------------------------------------------------------------------

def test_native_sources_are_the_jax_packages_and_build_apart():
    names = sorted(os.listdir(lib.SOURCE_DIR))
    assert names == ["base.h", "c_api.cc", "engine.cc", "engine.h",
                     "image_pipeline.cc", "recordio.cc"]
    for n in names:
        assert (Path(lib.SOURCE_DIR) / n).read_bytes() == \
            (REPO / "src" / n).read_bytes(), n
    assert lib.available() and lib.image_available(), \
        (lib.native_error(), lib.image_error())
    for nl in (lib._CORE, lib._IMAGE):
        assert os.path.dirname(nl.so_path) == str(REPO / "build" /
                                                 "torch_native")
        assert all(os.path.dirname(s) == lib.SOURCE_DIR for s in nl.sources)


def test_use_native_knob_is_read_at_each_call(monkeypatch):
    monkeypatch.setenv("MXNET_USE_NATIVE", "0")
    assert not lib.available() and not lib.image_available()
    assert lib.image_error() == "MXNET_USE_NATIVE=0"
    with pytest.raises(MXNetError, match="MXNET_USE_NATIVE=0"):
        lib.NativeEngine(1)
    monkeypatch.delenv("MXNET_USE_NATIVE")
    assert lib.available() and lib.native_error() is None


def test_a_failed_build_is_kept_with_its_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(lib, "BUILD_DIR", str(tmp_path))
    nl = lib._NativeLib("libbad.so", [str(bad)], [], "MXGetLastError",
                        "test", {})
    assert nl.load() is None and "build failed" in nl.error
    with pytest.raises(MXNetError, match="build failed"):
        nl.get()
    assert not list(tmp_path.glob("*.tmp"))
    # a library that does not load (left by another machine) is rebuilt
    good = tmp_path / "good.cc"
    good.write_text('extern "C" const char* Err() { return ""; }\n')
    so = tmp_path / "libgood.so"
    so.write_bytes(b"not a shared object")
    os.utime(so, (time.time() + 60, time.time() + 60))
    nl = lib._NativeLib("libgood.so", [str(good)], [], "Err", "test", {})
    assert nl.load() is not None and nl.error is None


@pytest.mark.parametrize("max_chunk", [0, 16])
def test_native_writer_writes_the_python_bytes(tmp_path, max_chunk):
    recs = _records(12, seed=2)
    py = trio.MXRecordIO(str(tmp_path / "py.rec"), "w")
    if max_chunk:
        py._max_chunk = max_chunk
    nw = lib.NativeRecordWriter(str(tmp_path / "nat.rec"), max_chunk)
    offsets = []
    for r in recs:
        offsets.append(py.tell())
        py.write(r)
        assert nw.write(r) == offsets[-1]
    py.close()
    nw.close()
    assert (tmp_path / "nat.rec").read_bytes() == \
        (tmp_path / "py.rec").read_bytes()
    rd = lib.NativeRecordReader(str(tmp_path / "py.rec"))
    assert [rd.read() for _ in recs] == recs and rd.read() is None
    rd.seek(offsets[5])
    assert rd.read() == recs[5]
    rd.close()
    pf = lib.NativePrefetchReader(str(tmp_path / "py.rec"), capacity=3)
    for _ in range(2):
        assert [pf.read() for _ in recs] == recs and pf.read() is None
        pf.reset()
    pf.close()
    with pytest.raises(MXNetError, match="closed"):
        pf.read()


def test_engine_orders_writes_and_shares_reads():
    eng = lib.NativeEngine(4)
    v, w = eng.new_variable(), eng.new_variable()
    log, lock = [], threading.Lock()

    def note(tag):
        def fn():
            with lock:
                log.append(tag)
        return fn

    for i in range(20):
        eng.push(note(("w", i)), write=[v])
    eng.push(note("r"), read=[v], write=[w])
    eng.wait_for_var(w)
    assert log[:20] == [("w", i) for i in range(20)] and log[20] == "r"
    assert eng.var_version(v) == 20 and eng.num_pending() == 0
    with pytest.raises(MXNetError):
        eng.push(note("x"), read=[v], write=[v])
    eng.wait_for_all()
    eng.delete_variable(w)
    eng.close()
    naive = lib.NativeEngine(0)
    out = []
    naive.push(lambda: out.append(1), write=[naive.new_variable()])
    assert out == [1]
    naive.close()


def test_engine_workers_follow_the_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "3")
    assert lib.NativeEngine().num_workers == 3
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert lib.NativeEngine().num_workers == 0


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
def test_fork_rebuilds_the_engine_and_invalidates_readers(tmp_path):
    path = str(tmp_path / "f.rec")
    w = lib.NativeRecordWriter(path)
    w.write(b"rec0")
    w.close()
    eng = lib.NativeEngine(2)
    v = eng.new_variable()
    for _ in range(8):
        eng.push(lambda: None, write=[v])
    rd = lib.NativeRecordReader(path)
    pid = os.fork()
    if pid == 0:
        rc = 1
        try:
            got = []
            eng.push(lambda: got.append(1), write=[eng.new_variable()])
            eng.wait_for_all()
            try:
                rd.read()
            except MXNetError as e:
                rc = 0 if got == [1] and "fork" in str(e) else 1
        finally:
            os._exit(rc)
    deadline = time.monotonic() + 60
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    if not done:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
    assert done and os.waitstatus_to_exitcode(status) == 0
    assert rd.read() == b"rec0"  # the parent's reader is untouched
    eng.wait_for_all()
    assert eng.var_version(v) == 8


# ---------------------------------------------------------------------------
# im2rec
# ---------------------------------------------------------------------------

def _jax_im2rec():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_im2rec", REPO / "tools" / "im2rec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    import cv2

    rs = np.random.RandomState(3)
    for c, cat in enumerate(["ant", "bee", "cat"]):
        d = root / cat / ("sub" if c == 2 else "")
        d.mkdir(parents=True, exist_ok=True)
        for i in range(3):
            img = rs.randint(0, 255, (20 + 4 * i, 28, 3), np.uint8)
            ext = ".png" if i == 2 else ".jpg"
            cv2.imwrite(str(d / f"{i}{ext}"), img)


@pytest.mark.parametrize("flags", [
    ["--resize", "16", "--center-crop", "--quality", "80"],
    ["--encoding", ".png", "--color", "0"],
    ["--pack-label", "--pass-through"]])
def test_im2rec_writes_the_jax_tools_bytes(tmp_path, monkeypatch, flags):
    _tree(tmp_path / "img")
    jtool = _jax_im2rec()
    outs = {}
    for tag in ("jax", "port"):
        prefix = str(tmp_path / tag)
        for extra in (["--list", "--recursive", "--shuffle",
                       "--train-ratio", "0.7"],
                      flags + ["--num-thread", "3"]):
            argv = [prefix, str(tmp_path / "img")] + extra
            if tag == "jax":
                monkeypatch.setattr(sys, "argv", ["im2rec.py"] + argv)
                assert jtool.main() == 0
            else:
                assert tim2rec.main(argv) == 0
        outs[tag] = {p.name[len(tag):]: p.read_bytes()
                     for p in tmp_path.glob(f"{tag}_*")}
    assert sorted(outs["port"]) == ["_train.idx", "_train.lst",
                                    "_train.rec", "_val.idx", "_val.lst",
                                    "_val.rec"]
    assert outs["port"] == outs["jax"]
    r = trio.MXIndexedRecordIO(str(tmp_path / "port_train.idx"),
                               str(tmp_path / "port_train.rec"), "r")
    h, _ = trio.unpack(r.read_idx(r.keys[0]))
    assert isinstance(h.label, np.ndarray) == ("--pack-label" in flags)


def test_im2rec_without_a_list_fails(tmp_path, capsys):
    assert tim2rec.main([str(tmp_path / "none"), str(tmp_path)]) == 1
    assert "run with --list first" in capsys.readouterr().err


def test_the_package_exports_the_image_path():
    assert mt.recordio is trio and mt.lib is lib
    assert mt.image.ImageIter and mt.nd.image.resize
    assert mt.gluon.data.RecordFileDataset
    assert mt.gluon.data.vision.ImageRecordDataset
    assert mt.gluon.data.vision.ImageFolderDataset
