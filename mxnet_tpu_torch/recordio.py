"""RecordIO: sequence-of-records container (reference
`python/mxnet/recordio.py`; C++ reader/writer came from dmlc-core).

A port of `mxnet_tpu/recordio.py`, the same code: a pack written by
either package is byte for byte the other's.

On-disk format matches dmlc recordio so packs interoperate with reference
tooling (`tools/im2rec.py`): each record is

    u32 magic (0xced7230a) | u32 lrec | data | pad to 4B

where lrec's upper 3 bits are a continuation flag (unused here: we write
single-part records) and lower 29 bits the length.  Image records prepend the
`IRHeader` struct 'IfQQ' (flag, label, id, id2) exactly like the reference
(`recordio.py:100-115`).

The C++ reader and threaded loader of the training pipelines live in the
port's `native/` (`_native`); this module is the pure-Python
implementation and the format authority.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

_MAGIC = 0xCED7230A
_LREC_MASK = (1 << 29) - 1

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IRFormat = "IfQQ"
_IRSize = struct.calcsize(_IRFormat)


def pack(header, s):
    """Prepend an IRHeader to a byte string (`recordio.py:104`)."""
    header = IRHeader(*header)
    return struct.pack(_IRFormat, *header) + s


def unpack(s):
    """Split a record into (IRHeader, payload) (`recordio.py` unpack)."""
    header = IRHeader(*struct.unpack(_IRFormat, s[:_IRSize]))
    return header, s[_IRSize:]


def unpack_img(s, iscolor=-1):
    """Unpack a record holding an encoded or raw image (reference
    `recordio.py` unpack_img, cv2.imdecode role).  Payload format is
    sniffed: JPEG/PNG decode via PIL to an HWC uint8 array; `.npy`
    payloads (written by `pack_img(..., img_fmt='.npy')`) load exactly."""
    header, s = unpack(s)
    import io as _io

    if s[:6] == b"\x93NUMPY":
        return header, np.load(_io.BytesIO(s), allow_pickle=False)
    from PIL import Image

    img = Image.open(_io.BytesIO(s))
    # convert() copies even when the mode already matches — skip the no-op
    # (a full extra image copy per record on the hot decode path)
    if iscolor == 0 and img.mode != "L":
        img = img.convert("L")
    elif (iscolor == 1 or (iscolor == -1 and img.mode != "L")) \
            and img.mode != "RGB":
        img = img.convert("RGB")
    return header, np.asarray(img)


def pack_img(header, img, quality=95, img_fmt=".npy"):
    """Pack an image (reference `recordio.py` pack_img, cv2.imencode role).

    img_fmt '.jpg'/'.jpeg' (lossy, `quality`) or '.png' encode via PIL from
    an HWC (or HW) uint8-able array; '.npy' stores the array bit-exact
    (any dtype/layout — the format used for float CHW training payloads).
    """
    import io as _io

    buf = _io.BytesIO()
    fmt = img_fmt.lower()
    if fmt in (".jpg", ".jpeg", ".png"):
        from PIL import Image

        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3, 4):
            arr = arr.transpose(1, 2, 0)  # CHW -> HWC
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        if np.issubdtype(arr.dtype, np.floating):
            # only reject what is *provably* 0..1-normalized; a legitimately
            # dark 0..255 float image (near-black crop) must pack fine
            if arr.size and arr.min() >= 0.0 and arr.max() <= 1.0:
                raise MXNetError(
                    "pack_img: float image values all in [0, 1] — scale to "
                    "0..255 before JPEG/PNG packing (or use img_fmt='.npy' "
                    "for bit-exact float payloads)")
            arr = np.clip(np.round(arr), 0, 255)
        pil = Image.fromarray(arr.astype(np.uint8))
        if fmt == ".png":
            pil.save(buf, format="PNG")
        else:
            pil.save(buf, format="JPEG", quality=quality)
    else:
        np.save(buf, np.asarray(img), allow_pickle=False)
    return pack(header, buf.getvalue())


# -- pluggable remote reads -------------------------------------------------
# The reference read s3:// and hdfs:// URIs through dmlc::InputSplit
# (`src/io/iter_image_recordio.cc:105-126` of the reference, dmlc-core
# filesystem providers).  Here the native loader and the python readers
# want a LOCAL file, so remote schemes go through a fetch hook that
# materializes (and may cache) the object locally — multi-host jobs
# register whatever their storage fabric needs (gcsfuse path rewrite,
# object-store download, ...).  `file://` is built in; plain paths pass
# through untouched.

_FETCH_HOOKS = {}


def register_fetch_hook(scheme, fetcher):
    """Register ``fetcher(uri) -> local_path`` for ``scheme://`` URIs.
    Returns the previous hook (None if none) so callers can restore it."""
    prev = _FETCH_HOOKS.get(scheme)
    _FETCH_HOOKS[scheme] = fetcher
    return prev


def resolve_uri(uri):
    """Map a data URI to a local filesystem path via the scheme hooks."""
    if "://" not in uri:
        return uri
    scheme, rest = uri.split("://", 1)
    if scheme == "file":
        if rest.startswith("/"):  # file:///abs/path
            return rest
        # file://host/path (RFC 8089): only the local host makes sense
        host, _, path = rest.partition("/")
        if host not in ("", "localhost"):
            raise MXNetError(
                "file:// URIs with a remote authority (%r) are not "
                "supported; register a fetch hook for remote reads" % host)
        return "/" + path
    hook = _FETCH_HOOKS.get(scheme)
    if hook is None and scheme in ("http", "https"):
        hook = http_fetch  # built-in (overridable via register_fetch_hook)
    if hook is None:
        raise MXNetError(
            "no fetch hook registered for %r URIs (register one with "
            "mxnet_tpu_torch.recordio.register_fetch_hook(%r, fetcher))"
            % (scheme, scheme))
    local = hook(uri)
    if not isinstance(local, str) or not os.path.exists(local):
        raise MXNetError(
            "fetch hook for %r returned %r, which is not an existing "
            "local path" % (scheme, local))
    return local


def http_fetch(uri, cache_dir=None, chunk=1 << 20):
    """Built-in ``http://``/``https://`` fetcher (the dmlc-core
    filesystem-provider role for plain web storage; the reference's
    s3/hdfs providers live at `dmlc-core/src/io/` behind
    `iter_image_recordio.cc:105-126`).

    Streams the object to ``<cache>/<sha1(uri)>-<basename>`` and returns
    that local path.  A completed download is cached — identical URIs
    resolve without touching the network again (delete the cache file or
    set ``MXNET_FETCH_REFRESH=1`` to force a clean re-fetch, stale
    partials included).  An interrupted download leaves ``<path>.part``;
    the next fetch CLAIMS it with an atomic rename (so concurrent ranks
    fetching the same URI can never interleave writes — the rename loser
    just starts its own fresh download) and resumes via a Range request
    when the server honors ranges (HTTP 206), restarting from scratch
    otherwise.  Resume freshness: the partial's server validator
    (ETag/Last-Modified, parked alongside as ``.part.meta``) is sent as
    ``If-Range`` so a republished object comes back 200-whole instead of
    splicing; a resumed download is additionally length-checked against
    the Content-Range total (covers validator-less servers when the size
    changed — a same-size republish on a validator-less server is not
    detectable).  All network failures surface as ``MXNetError`` (the
    module's fetch contract); a mid-stream failure re-parks the bytes as
    ``.part`` for the next resume.  The final rename is atomic, so a
    concurrent reader can never observe a torn file at the returned
    path.
    """
    import hashlib

    cache_dir = cache_dir or os.environ.get(
        "MXNET_FETCH_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "mxnet_tpu",
                     "fetch"))
    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.basename(uri.split("?", 1)[0].rstrip("/")) or "object"
    path = os.path.join(
        cache_dir,
        "%s-%s" % (hashlib.sha1(uri.encode()).hexdigest()[:16], base))
    part = path + ".part"
    refresh = os.environ.get("MXNET_FETCH_REFRESH", "0") == "1"
    if refresh:
        for stale in (path, part, part + ".meta"):
            try:
                os.remove(stale)
            except FileNotFoundError:
                pass
    elif os.path.exists(path):
        return path
    # exclusive work file: claim an existing .part by atomic rename (only
    # one process can win; losers fall through to a fresh download), else
    # start fresh under a unique name
    work = "%s.tmp-%d" % (path, os.getpid())
    offset = 0
    validator = None
    try:
        os.rename(part, work)
        offset = os.path.getsize(work)
        try:
            with open(part + ".meta") as f:
                validator = f.read().strip() or None
            os.remove(part + ".meta")
        except OSError:
            pass
    except OSError:
        pass
    try:
        # Length-checked retry loop: urllib reports a mid-body connection
        # loss as a quiet short read (read(amt) returns EOF), so
        # truncation is only detectable against the server's stated
        # total.  A short file resumes (Range from its end); an
        # over-long file (stale partial spliced with a republished,
        # smaller object) is discarded and re-fetched whole.
        last = None
        meta = {"validator": validator}
        for _ in range(3):
            total, validator = _http_stream(uri, work, offset, chunk,
                                            validator, meta_out=meta)
            size = os.path.getsize(work)
            if total is None or size == total:
                os.replace(work, path)
                return path
            last = (size, total)
            if size > total:
                os.remove(work)
                offset = 0
            else:
                offset = size
        raise MXNetError(
            "http fetch of %r kept arriving truncated (%d of %d bytes "
            "after retries)" % (uri, last[0], last[1]))
    except MXNetError:
        # park whatever arrived (plus its freshness validator) for the
        # next resume — unless a parked partial already exists: never
        # clobber another rank's bytes
        try:
            if os.path.getsize(work) > 0 and not os.path.exists(part):
                # meta carries the validator captured from the response
                # headers even when the body died mid-stream — without
                # it, the next resume would have no If-Range freshness
                # check on the common interruption path
                parked_validator = meta.get("validator")
                if parked_validator:
                    with open(part + ".meta", "w") as f:
                        f.write(parked_validator)
                os.rename(work, part)
            else:
                os.remove(work)
        except OSError:
            pass
        raise
    except BaseException:
        try:
            os.remove(work)
        except OSError:
            pass
        raise


def _http_stream(uri, work, offset, chunk, validator=None, meta_out=None):
    """GET ``uri`` into ``work`` (append from ``offset`` when the server
    grants the Range, truncate+restart otherwise).  ``validator`` is the
    partial's ETag/Last-Modified, sent as ``If-Range`` so a server that
    republished the object since returns 200-whole instead of splicing.
    Returns (total size or None, response validator or None); the
    response validator is also published into ``meta_out['validator']``
    as soon as headers arrive, so a mid-body failure still leaves the
    caller the validator to park beside the partial.  Every network
    error — connect, HTTP status, or mid-body — raises MXNetError."""
    import http.client
    import urllib.error
    import urllib.request

    req = urllib.request.Request(uri)
    if offset:
        req.add_header("Range", "bytes=%d-" % offset)
        if validator:
            req.add_header("If-Range", validator)
    try:
        resp = urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:
        if offset and e.code == 416:
            # our offset is past the object's end (stale partial from a
            # republished, now-smaller object — or a crash after the
            # final byte; indistinguishable in general, so re-fetch
            # whole for correctness)
            return _http_stream(uri, work, 0, chunk, meta_out=meta_out)
        raise MXNetError("http fetch of %r failed: %s" % (uri, e))
    except urllib.error.URLError as e:
        raise MXNetError("http fetch of %r failed: %s" % (uri, e))
    total = None
    resp_validator = resp.headers.get("ETag") \
        or resp.headers.get("Last-Modified")
    if meta_out is not None and resp_validator:
        meta_out["validator"] = resp_validator
    try:
        with resp:
            if offset and resp.status == 206:
                rng = resp.headers.get("Content-Range", "")
                if "/" in rng and rng.split("/")[-1].isdigit():
                    total = int(rng.split("/")[-1])
                mode = "ab"
            else:
                offset = 0  # server ignored the Range: restart whole
                length = resp.headers.get("Content-Length")
                total = int(length) if length and length.isdigit() \
                    else None
                mode = "wb"
            with open(work, mode) as f:
                while True:
                    buf = resp.read(chunk)
                    if not buf:
                        break
                    f.write(buf)
    except (OSError, http.client.HTTPException) as e:
        raise MXNetError(
            "http fetch of %r failed mid-stream after %d bytes: %s"
            % (uri, os.path.getsize(work) if os.path.exists(work) else 0,
               e)) from e
    return total, resp_validator


class MXRecordIO:
    """Sequential reader/writer (`recordio.py` MXRecordIO).  Read URIs go
    through `resolve_uri` (the dmlc::InputSplit remote-read role)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._local_path = None  # fetched-once resolution of a remote uri
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            # resolve once: reset() must not re-invoke a (possibly
            # downloading) fetch hook every epoch
            if self._local_path is None:
                self._local_path = resolve_uri(self.uri)
            self.handle = open(self._local_path, "rb")
            self.writable = False
        else:
            raise MXNetError("invalid flag %r" % self.flag)

    def close(self):
        if self.handle:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def write(self, buf):
        if not self.writable:
            raise MXNetError("not opened for writing")
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        self.handle.write(struct.pack("<II", _MAGIC, len(buf) & _LREC_MASK))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        if self.writable:
            raise MXNetError("not opened for reading")
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic at offset %d" % (self.tell() - 8))
        length = lrec & _LREC_MASK
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Indexed random-access variant (`recordio.py` MXIndexedRecordIO):
    sidecar .idx file of `key\\toffset` lines."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as fin:
                for line in fin:
                    key, off = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(off)
                    self.keys.append(key)

    def close(self):
        if self.writable and self.idx:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)
