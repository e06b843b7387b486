"""The port's recordio and native runtime against the JAX package's.

A pack written by either package's `MXRecordIO`, or by the port's C++
writer, is byte for byte the same file and reads in the other package
(plain and indexed, with the `.idx` files equal too); `pack`, `unpack`,
`pack_img` and `unpack_img` give the same bytes and arrays for .npy, PNG
and JPEG payloads; the C++ reader's byte-range shards cover every record
once, in order; the fetch hooks resolve `file://` and custom schemes and
refuse the rest; and the built-in `http://` fetcher caches, resumes with
a Range request and restarts against a server that ignores ranges, on a
loopback server only.  The port's native library is built at first use
into `mxnet_tpu_torch/_build/`.
"""
import ctypes
import hashlib
import http.server
import os
import struct
import threading

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError

PAYLOADS = [bytes([i % 251]) * (i * 7 % 50 + 1) for i in range(20)]


def _write(mod, path, payloads):
    w = mod.MXRecordIO(str(path), "w")
    for p in payloads:
        w.write(p)
    w.close()


def _write_native(path, payloads):
    lib = _native.lib()
    h = lib.mxtpu_recio_writer_open(str(path).encode())
    _native.check(h != 0, "writer_open")
    for p in payloads:
        assert lib.mxtpu_recio_write(h, p, len(p)) == 0
    lib.mxtpu_recio_writer_close(h)


def _read_all(mod, path):
    r = mod.MXRecordIO(str(path), "r")
    out = []
    while True:
        b = r.read()
        if b is None:
            break
        out.append(b)
    r.close()
    return out


def _read_native(path, part=0, nparts=1):
    lib = _native.lib()
    h = lib.mxtpu_recio_reader_open(str(path).encode(), part, nparts)
    _native.check(h != 0, "reader_open")
    out = []
    ln = ctypes.c_uint64()
    while True:
        p = lib.mxtpu_recio_read(h, ctypes.byref(ln))
        if not p:
            break
        out.append(ctypes.string_at(p, ln.value))
    lib.mxtpu_recio_reader_close(h)
    return out


WRITERS = {"jax": lambda p, x: _write(jrec, p, x),
           "port": lambda p, x: _write(trec, p, x),
           "port_native": _write_native}
READERS = {"jax": lambda p: _read_all(jrec, p),
           "port": lambda p: _read_all(trec, p),
           "port_native": _read_native}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_a_pack_is_byte_for_byte_the_same_from_every_writer(tmp_path,
                                                           writer):
    WRITERS["jax"](tmp_path / "ref.rec", PAYLOADS)
    WRITERS[writer](tmp_path / "got.rec", PAYLOADS)
    assert (tmp_path / "got.rec").read_bytes() == \
        (tmp_path / "ref.rec").read_bytes()


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("reader", sorted(READERS))
def test_every_reader_reads_every_writers_pack(tmp_path, writer, reader):
    WRITERS[writer](tmp_path / "p.rec", PAYLOADS)
    assert READERS[reader](tmp_path / "p.rec") == PAYLOADS


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_indexed_packs_are_the_same_and_read_across(tmp_path, writer,
                                                    reader):
    files = {}
    for name, mod in (("w", writer), ("r", reader)):
        idx, rec = tmp_path / (name + ".idx"), tmp_path / (name + ".rec")
        w = mod.MXIndexedRecordIO(str(idx), str(rec), "w")
        for i in (3, 1, 4, 15, 9):
            w.write_idx(i, mod.pack(mod.IRHeader(0, float(i), i, 0),
                                    PAYLOADS[i]))
        w.close()
        files[name] = (idx.read_bytes(), rec.read_bytes())
    assert files["w"] == files["r"]
    r = reader.MXIndexedRecordIO(str(tmp_path / "w.idx"),
                                 str(tmp_path / "w.rec"), "r")
    assert r.keys == [3, 1, 4, 15, 9]
    for i in (15, 1, 9):
        header, body = reader.unpack(r.read_idx(i))
        assert (header.label, header.id, body) == (float(i), i, PAYLOADS[i])
    r.close()


@pytest.mark.parametrize("fmt", [".npy", ".png", ".jpg"])
def test_pack_img_and_unpack_img_agree_with_the_jax_package(fmt):
    rng = np.random.RandomState(1)
    if fmt == ".npy":
        img = rng.rand(3, 6, 5).astype(np.float32)
    else:
        img = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    header = (0, 2.5, 7, 1)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    for iscolor in (-1, 1):
        (h1, a1), (h2, a2) = (trec.unpack_img(s, iscolor),
                              jrec.unpack_img(s, iscolor))
        assert tuple(h1) == tuple(h2) == header
        np.testing.assert_array_equal(a1, a2)
    assert trec.unpack(trec.pack(header, b"xyz")) == \
        (trec.IRHeader(*header), b"xyz")


def test_pack_img_refuses_normalized_floats():
    img = np.random.RandomState(0).rand(4, 4, 3)
    with pytest.raises(MXNetError):
        trec.pack_img((0, 0.0, 0, 0), img, img_fmt=".png")


@pytest.mark.parametrize("nparts", [2, 3, 4])
def test_native_shards_cover_every_record_once_in_order(tmp_path, nparts):
    rng = np.random.RandomState(nparts)
    payloads = [rng.bytes(37 + i % 91) for i in range(61)]
    _write(trec, tmp_path / "s.rec", payloads)
    got = []
    for part in range(nparts):
        got += _read_native(tmp_path / "s.rec", part, nparts)
    assert got == payloads


def test_native_and_python_readers_agree_on_a_real_pack(tmp_path):
    rng = np.random.RandomState(2)
    payloads = [trec.pack_img((0, float(i), i, 0),
                              rng.randint(0, 256, (3, 8, 8)).astype(np.uint8))
                for i in range(12)]
    _write(trec, tmp_path / "i.rec", payloads)
    assert _read_native(tmp_path / "i.rec") == \
        _read_all(trec, tmp_path / "i.rec") == payloads


def test_fetch_hooks(tmp_path):
    path = str(tmp_path / "h.rec")
    _write(trec, path, PAYLOADS[:3])
    assert trec.resolve_uri(path) == path
    assert trec.resolve_uri("file://" + path) == path
    assert trec.resolve_uri("file://localhost" + path) == path
    with pytest.raises(MXNetError):
        trec.resolve_uri("file://elsewhere" + path)
    with pytest.raises(MXNetError):
        trec.resolve_uri("nosuch://bucket/h.rec")
    fetched = []

    def hook(uri):
        fetched.append(uri)
        return path

    prev = trec.register_fetch_hook("fakes3", hook)
    try:
        assert _read_all(trec, "fakes3://bucket/h.rec") == PAYLOADS[:3]
        assert fetched == ["fakes3://bucket/h.rec"]
        trec.register_fetch_hook("fakes3", lambda uri: "/no/such/file")
        with pytest.raises(MXNetError):
            trec.resolve_uri("fakes3://bucket/h.rec")
    finally:
        trec.register_fetch_hook("fakes3", prev)


class _Handler(http.server.BaseHTTPRequestHandler):
    """Static files from ``root``, with Range support unless ``ranges`` is
    off; every request is logged as (path, Range header)."""

    root = "."
    ranges = True
    log = None

    def do_GET(self):
        self.log.append((self.path, self.headers.get("Range")))
        fpath = os.path.join(self.root, self.path.lstrip("/"))
        if not os.path.isfile(fpath):
            self.send_error(404)
            return
        with open(fpath, "rb") as f:
            data = f.read()
        rng = self.headers.get("Range")
        if rng and self.ranges:
            start = int(rng.split("=")[1].rstrip("-").split("-")[0])
            body = data[start:]
            self.send_response(206)
            self.send_header("Content-Range", "bytes %d-%d/%d"
                             % (start, len(data) - 1, len(data)))
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def http_root(tmp_path, monkeypatch):
    root = tmp_path / "www"
    root.mkdir()
    handler = type("H", (_Handler,), {"root": str(root), "log": []})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    monkeypatch.setenv("MXNET_FETCH_CACHE", str(tmp_path / "cache"))
    try:
        yield "http://127.0.0.1:%d" % srv.server_address[1], root, handler
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_reads_through_the_cache(http_root):
    base, root, handler = http_root
    _write(trec, root / "d.rec", PAYLOADS)
    assert _read_all(trec, base + "/d.rec") == PAYLOADS
    n = len(handler.log)
    r = trec.MXRecordIO(base + "/d.rec", "r")
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()
    assert len(handler.log) == n  # a cached object is not fetched again
    with pytest.raises(MXNetError):
        trec.resolve_uri(base + "/missing.rec")


@pytest.mark.parametrize("ranges", [True, False])
def test_http_resumes_a_partial_or_restarts_it(http_root, ranges):
    base, root, handler = http_root
    handler.ranges = ranges
    _write(trec, root / "r.rec", PAYLOADS)
    data = (root / "r.rec").read_bytes()
    uri = base + "/r.rec"
    # the partial an interrupted fetch parks beside the cached path
    cached = hashlib.sha1(uri.encode()).hexdigest()[:16]
    part = os.path.join(os.environ["MXNET_FETCH_CACHE"],
                        "%s-r.rec.part" % cached)
    os.makedirs(os.path.dirname(part), exist_ok=True)
    with open(part, "wb") as f:
        f.write(data[:100])
    local = trec.http_fetch(uri)
    assert open(local, "rb").read() == data
    assert handler.log[-1] == ("/r.rec", "bytes=100-")
    assert not os.path.exists(part)
    # the JAX package names the same cache file, and finds it there
    n = len(handler.log)
    assert jrec.http_fetch(uri) == local
    assert len(handler.log) == n


def test_ir_header_layout_is_the_reference_struct():
    s = trec.pack(trec.IRHeader(1, 2.0, 3, 4), b"")
    assert s == struct.pack("IfQQ", 1, 2.0, 3, 4)


def _iter_kw(path, **kw):
    return dict(path_imgrec=str(path), data_shape=(3, 8, 8), batch_size=4,
                **kw)


def test_a_failed_native_build_raises_and_nothing_falls_back(
        tmp_path, monkeypatch):
    import mxnet_tpu_torch as mt

    path = tmp_path / "n.rec"
    w = trec.MXRecordIO(str(path), "w")
    w.write(trec.pack_img((0, 1.0, 0, 0), np.zeros((3, 8, 8), np.uint8)))
    w.close()
    monkeypatch.delenv("MXNET_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-g++"))
    with mt.cpu():
        for native in (None, True):
            with pytest.raises(MXNetError, match="no-such-g"):
                mt.io.ImageRecordIter(**_iter_kw(path, use_native=native))
        with pytest.raises(MXNetError, match="no-such-g"):
            mt.engine.NativeEngine()
        # the Python path runs where it is asked for
        it = mt.io.ImageRecordIter(**_iter_kw(path, use_native=False))
        assert it.next().label[0].asnumpy()[0] == 1.0


def test_a_build_without_libjpeg_refuses_jpeg_packs(tmp_path, monkeypatch):
    """Where jpeglib.h is missing the library builds without its JPEG
    decoder, and a JPEG pack raises, up front or, for a JPEG past the
    sniffed records, at the batch that holds it; nothing is zero-filled."""
    import mxnet_tpu_torch as mt

    monkeypatch.delenv("MXNET_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_probe_jpeg", lambda: False)
    assert not _native.has_jpeg()
    assert _native.build_info["jpeg"] is False
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    jpeg = tmp_path / "j.rec"
    _write(trec, jpeg, [trec.pack_img((0, 0.0, 0, 0), img, img_fmt=".jpg")])
    late = tmp_path / "late.rec"
    _write(trec, late,
           [trec.pack_img((0, float(i), i, 0), img.transpose(2, 0, 1))
            for i in range(8)]
           + [trec.pack_img((0, 8.0, 8, 0), img, img_fmt=".jpg")])
    with mt.cpu():
        with pytest.raises(MXNetError, match="libjpeg"):
            mt.io.ImageRecordIter(**_iter_kw(jpeg))
        it = mt.io.ImageRecordIter(**_iter_kw(late))
        assert it._native
        for _ in range(2):
            assert it.next().pad == 0
        with pytest.raises(MXNetError, match="libjpeg"):
            it.next()
        it.close()
        # PIL decodes it where the caller asks for the Python path
        it = mt.io.ImageRecordIter(**_iter_kw(jpeg, use_native=False))
        assert it.next().data[0].shape == (4, 3, 8, 8)
    lib = _native.lib()
    n_failed = ctypes.c_int64(-1)
    assert lib.mxtpu_im2rec_pack(b"x", b"y", b"z", 0, 90, 1,
                                 ctypes.byref(n_failed)) == -1
    assert "libjpeg" in _native.last_error()
