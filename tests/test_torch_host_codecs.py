"""The port's own host codecs (``yolo_scratch_tpu_torch/csrc``: inflate,
PNG, JPEG and the batch pipeline over them) against the JAX package's
native tier, which decodes with zlib, libpng's simplified API and
libjpeg-turbo.

The reference is built here, once a session, into the session's temporary
directory: the JAX package's ``csrc/yst_host.cpp`` compiled with ``-lpng
-ljpeg -lz`` together with ``REF_SHIM`` below, which adds one entry point on
that translation unit's own code: ``ref_decode``, a PNG decode through the
same simplified-API call onto a zeroed buffer and a JPEG decode through the
same libjpeg calls at any ``scale_num``/8. (``yolo_scratch_tpu.data.native``
builds in place under ``csrc/``, which races across test workers.)

Stated tolerance: exact, every byte and every status, on every case. The
JPEG decoder follows libjpeg-turbo through arithmetic coding and block
smoothing, the PNG decoder libpng through its colour chunks and its table
sRGB encoder (``tests/test_torch_host_codecs_arith.py`` holds those). Two
behaviours of the reference are not the port's, by design (``ROADMAP.md``
section 3):

* 16-bit Adam7 PNGs: libpng 1.6.39's simplified API garbles the rows that
  several passes fill, so the port's decode is held to the reference's
  decode of the same samples written without interlace;
* alpha: the JAX tier's ``decode_png`` composites onto an uninitialised
  buffer; ``REF_SHIM`` composites onto a zeroed one, as the port does.
"""

import ctypes
import io
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from yolo_scratch_tpu_torch.data import native

REPO = Path(__file__).resolve().parent.parent

REF_SHIM = r"""
#include "yst_host.cpp"
extern "C" uint8_t* ref_decode(const uint8_t* data, size_t size, int channels,
                               int scale_num, int* w, int* h) {
  if (is_png(data, size)) {
    png_image image;
    std::memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, size)) return nullptr;
    image.format = (channels == 1) ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
    *w = image.width;
    *h = image.height;
    uint8_t* buf = (uint8_t*)std::calloc(PNG_IMAGE_SIZE(image), 1);
    if (!png_image_finish_read(&image, nullptr, buf, (png_int_32)PNG_IMAGE_ROW_STRIDE(image),
                               nullptr)) {
      std::free(buf);
      png_image_free(&image);
      return nullptr;
    }
    return buf;
  }
  if (!is_jpeg(data, size)) return nullptr;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.output_message = [](j_common_ptr) {};
  uint8_t* volatile buf = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(buf);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t row = (size_t)(*w) * channels;
  buf = (uint8_t*)std::malloc(row * (*h));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = buf + (size_t)cinfo.output_scanline * row;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return buf;
}

// A lossless re-encode of a JPEG's coefficients, as jpegtran does it:
// arithmetic (arith 1) or Huffman coding, sequential or progressive
// (jpeg_simple_progression), a restart interval in MCUs and, for arithmetic
// coding, tables 0 and 1's DAC conditioning (L, U for DC; Kx for AC).
// Returns a malloc'd file of *out_n bytes, or nullptr.
extern "C" uint8_t* ref_transcode(const uint8_t* data, size_t size, int arith, int progressive,
                                  int restart, int dc_l, int dc_u, int ac_k, size_t* out_n) {
  jpeg_decompress_struct src;
  jpeg_compress_struct dst;
  JpegErr e1, e2;
  src.err = jpeg_std_error(&e1.mgr);
  e1.mgr.error_exit = jpeg_err_exit;
  e1.mgr.output_message = [](j_common_ptr) {};
  dst.err = jpeg_std_error(&e2.mgr);
  e2.mgr.error_exit = jpeg_err_exit;
  e2.mgr.output_message = [](j_common_ptr) {};
  unsigned char* volatile out = nullptr;
  unsigned long n = 0;
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  if (setjmp(e1.jb) || setjmp(e2.jb)) {
    jpeg_destroy_compress(&dst);
    jpeg_destroy_decompress(&src);
    std::free(out);
    return nullptr;
  }
  jpeg_mem_src(&src, const_cast<uint8_t*>(data), size);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = FALSE;
  if (progressive) jpeg_simple_progression(&dst);
  dst.restart_interval = (unsigned)restart;
  for (int i = 0; i < 2; ++i) {
    dst.arith_dc_L[i] = (UINT8)dc_l;
    dst.arith_dc_U[i] = (UINT8)dc_u;
    dst.arith_ac_K[i] = (UINT8)ac_k;
  }
  jpeg_mem_dest(&dst, (unsigned char**)&out, &n);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_compress(&dst);
  jpeg_destroy_decompress(&src);
  *out_n = n;
  return out;
}
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_reference(out_dir: Path) -> Path:
    """The JAX tier's host library plus ``REF_SHIM``, linked against libpng,
    libjpeg and zlib, as ``out_dir/libref_host.so``."""
    shim = out_dir / "ref_shim.cpp"
    shim.write_text(REF_SHIM)
    so = out_dir / "libref_host.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{REPO / 'csrc'}",
                    str(shim), "-lpng", "-ljpeg", "-lz", "-pthread", "-o", str(so)],
                   check=True, capture_output=True, timeout=240)
    return so


def bind(lib):
    lib.ref_decode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ref_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ref_transcode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ref_transcode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, *[ctypes.c_int] * 6,
                                  ctypes.POINTER(ctypes.c_size_t)]
    lib.yst_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


def transcode(lib, data: bytes, arith: bool = True, progressive: bool = False,
              restart: int = 0, dac=(0, 1, 5)) -> bytes:
    """``data``'s coefficients re-encoded by the reference's libjpeg (see
    ``ref_transcode``); ``dac`` is (L, U, Kx), libjpeg's defaults here."""
    n = ctypes.c_size_t()
    p = lib.ref_transcode(data, len(data), int(arith), int(progressive), restart, *dac,
                          ctypes.byref(n))
    assert p, "libjpeg could not transcode the file"
    out = ctypes.string_at(p, n.value)
    lib.yst_free(p)
    return out


@pytest.fixture(scope="session")
def ref_so(tmp_path_factory):
    return build_reference(tmp_path_factory.mktemp("ref_host"))


@pytest.fixture(scope="session")
def ref(ref_so):
    return bind(ctypes.CDLL(str(ref_so)))


def ref_decode(lib, data: bytes, ch: int, num: int = 8):
    w, h = ctypes.c_int(), ctypes.c_int()
    p = lib.ref_decode(data, len(data), ch, num, ctypes.byref(w), ctypes.byref(h))
    if not p:
        return None
    a = np.ctypeslib.as_array(p, shape=(w.value * h.value * ch,)).copy()
    lib.yst_free(p)
    return a.reshape(h.value, w.value, ch)


def port_decode(data: bytes, ch: int, num: int = 8):
    try:
        return native.decode_bytes(data, ch, num)
    except IOError:
        return None


def assert_same(data: bytes, what: str, nums=(8,), chs=(1, 3), ref_lib=None, tol=0):
    for ch in chs:
        for num in nums:
            a, b = ref_decode(ref_lib, data, ch, num), port_decode(data, ch, num)
            assert (a is None) == (b is None), f"{what} ch{ch} {num}/8: status ref {a is None}, port {b is None}"
            if a is None:
                continue
            assert a.shape == b.shape, f"{what} ch{ch} {num}/8: {a.shape} vs {b.shape}"
            d = int(np.abs(a.astype(int) - b.astype(int)).max()) if a.size else 0
            assert d <= tol, f"{what} ch{ch} {num}/8: max|diff| {d} > {tol}"


# ------------------------------------------------------------------ inflate

def _payload(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, 256, n).astype(np.uint8).tobytes()
    if kind == "runs":
        return np.repeat(rng.randint(0, 4, n // 50 + 1), 50)[:n].astype(np.uint8).tobytes()
    words = [b"crater ", b"rim ", b"ejecta ", b"0.5 ", b"\n", b"floor "]
    return b"".join(words[i] for i in rng.randint(0, len(words), n // 4 + 1))[:n]


STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "fixed": zlib.Z_FIXED,
              "huffman": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE}


@settings(max_examples=25, deadline=None)
@given(size=st.integers(0, 1 << 20), seed=st.integers(0, 2 ** 31 - 1), level=st.integers(0, 9),
       strategy=st.sampled_from(sorted(STRATEGIES)),
       kind=st.sampled_from(["random", "runs", "text"]))
def test_inflate_matches_zlib(size, seed, level, strategy, kind):
    """Stored (level 0), fixed (Z_FIXED) and dynamic blocks, 0 B to 1 MiB."""
    data = _payload(kind, size, seed)
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, STRATEGIES[strategy])
    z = c.compress(data) + c.flush()
    assert native.inflate(z, len(data)) == ("ok", data)
    if data:
        st_, out = native.inflate(z, len(data) - 1)
        assert st_ == "out of room" and out == data[:-1]


def test_inflate_faults():
    data = _payload("text", 5000, 0) + _payload("random", 3000, 1)
    for level in (0, 1, 6, 9):
        z = zlib.compress(data, level)
        for cut in sorted({0, 1, 2, 3, 7, len(z) // 3, len(z) // 2, len(z) - 5, len(z) - 4,
                           len(z) - 1}):
            assert native.inflate(z[:cut], len(data))[0] == "truncated", (level, cut)
        bad = z[:-1] + bytes([z[-1] ^ 0x10])
        assert native.inflate(bad, len(data)) == ("bad adler32", data)
    z = zlib.compress(data, 6)
    assert native.inflate(b"\x78\x9c"[:1] + b"\x9d" + z[2:], len(data))[0] == "bad data"  # FCHECK
    assert native.inflate(b"\x78\xbb" + z[2:], len(data))[0] == "bad data"  # FDICT
    assert native.inflate(b"\x79\x9c" + z[2:], len(data))[0] == "bad data"  # not deflate
    assert native.inflate(b"\x78\x9c\x07\x00", 10)[0] == "bad data"  # block type 3
    stored = b"\x78\x01\x01\x05\x00\xfb\xff" + b"hello"  # NLEN != ~LEN
    assert native.inflate(stored, 10)[0] == "bad data"
    far = zlib.compress(b"a", 0)[:2] + bytes([0x63, 0x00, 0x02, 0x00])  # a copy before any output
    assert native.inflate(far, 10)[0] in ("bad data", "truncated")


# Bit flips run in a subprocess, so that a crash fails the test instead of
# killing the worker. It prints one JSON object: the flips whose status (and
# pixels, when both decode) differ from the reference build's.
FUZZ = r"""
import ctypes, json, sys, zlib
import numpy as np
sys.path.insert(0, sys.argv[1])
from yolo_scratch_tpu_torch.data import native
sys.path.insert(0, sys.argv[3])
from test_torch_host_codecs import bind, ref_decode, port_decode
ref = bind(ctypes.CDLL(sys.argv[2]))
rng = np.random.RandomState(0)
files = json.loads(sys.stdin.read())
out = {"inflate_statuses": set(), "mismatch": []}
data = bytes(rng.randint(0, 256, 4000).astype(np.uint8)) + b"crater " * 500
for level in (0, 1, 9):
    z = zlib.compress(data, level)
    for i in range(300):
        b = bytearray(z); p = rng.randint(len(b)); b[p] ^= 1 << rng.randint(8)
        out["inflate_statuses"].add(native.inflate(bytes(b), len(data))[0])
for name, hexdata in files.items():
    d = bytes.fromhex(hexdata)
    for i in range(120):
        b = bytearray(d); p = rng.randint(2, len(b)); b[p] ^= 1 << rng.randint(8)
        b = bytes(b)
        for ch in (1, 3):
            x, y = ref_decode(ref, b, ch), port_decode(b, ch)
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                out["mismatch"].append([name, p, ch])
out["inflate_statuses"] = sorted(out["inflate_statuses"])
print(json.dumps(out))
"""


def _files_for_fuzz():
    rng = np.random.RandomState(3)
    img = np.clip(rng.randn(37, 45, 3) * 40 + 128, 0, 255).astype(np.uint8)
    out = {}
    for name, kw in [("baseline", {}), ("restart", {"rst": 2})]:
        params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, kw.get("rst", 0)]
        out[name] = cv2.imencode(".jpg", img, params)[1].tobytes()
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG")
    out["png"] = b.getvalue()
    out["png_adam7"] = make_png(20, 17, 2, 8, interlace=1)[0]
    return out


def test_corrupt_inputs_never_crash_and_match_reference(ref_so, ref):
    files = _files_for_fuzz()
    for name, kw in (("arith_seq_rst", dict(restart=2, dac=(1, 4, 3))),
                     ("arith_prog", dict(progressive=True))):
        files[name] = transcode(ref, files["baseline"], True, **kw)
    files = {k: v.hex() for k, v in files.items()}
    proc = subprocess.run([sys.executable, "-c", FUZZ, str(REPO), str(ref_so),
                           str(Path(__file__).parent)], input=json.dumps(files),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(res["inflate_statuses"]) <= {"ok", "bad adler32", "truncated", "bad data",
                                            "out of room"}
    assert "bad data" in res["inflate_statuses"]
    assert res["mismatch"] == []


# ---------------------------------------------------------------------- PNG

ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]


def chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _row_bytes(row: np.ndarray, depth: int) -> bytes:
    flat = row.reshape(-1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros((-len(flat)) % per, np.int64)]).reshape(-1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (flat << shifts).sum(1).astype(np.uint8).tobytes()


def _filter(raw: np.ndarray, prev: np.ndarray, bpp: int, ft: int) -> np.ndarray:
    out = np.zeros_like(raw)
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ft == 0:
            p = 0
        elif ft == 1:
            p = a
        elif ft == 2:
            p = b
        elif ft == 3:
            p = (a + b) // 2
        else:
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (raw[i] - p) & 255
    return out


def make_png(h, w, ctype, depth, interlace=0, samples=None, trns=None, palette=None, seed=0,
             level=6, chunk_size=0):
    """A PNG built byte by byte: every filter type in turn, Adam7 on request,
    PLTE / tRNS as given, the image data split into IDATs of ``chunk_size``."""
    rng = np.random.RandomState(seed)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if samples is None:
        samples = rng.randint(0, 1 << depth, size=(h, w, nch))
    bpp = max(1, nch * depth // 8)
    raw = b""
    k = 0
    for x0, y0, dx, dy in (ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for row in sub:
            rb = np.frombuffer(_row_bytes(row, depth), np.uint8).astype(np.int64)
            ft = k % 5
            k += 1
            raw += bytes([ft]) + _filter(rb, np.zeros_like(rb) if prev is None else prev, bpp,
                                         ft).astype(np.uint8).tobytes()
            prev = rb
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                            interlace))
    if ctype == 3:
        pal = palette if palette is not None else rng.randint(0, 256, 3 << depth)
        data += chunk(b"PLTE", bytes(np.asarray(pal, np.uint8)))
    if trns is not None:
        data += chunk(b"tRNS", trns)
    z = zlib.compress(raw, level)
    step = chunk_size or len(z) or 1
    for i in range(0, max(len(z), 1), step):
        data += chunk(b"IDAT", z[i: i + step])
    return data + chunk(b"IEND", b""), samples


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_matrix(ref, ctype, depth):
    """Colour type x bit depth x interlace x requested channels, with tRNS
    (key colour or palette alpha) where the type takes it, and an opaque
    variant of each alpha type."""
    for interlace in (0, 1):
        for i, (h, w) in enumerate([(1, 1), (7, 13), (17, 9), (33, 20)]):
            seed = 100 * ctype + 10 * depth + i
            data, s = make_png(h, w, ctype, depth, interlace, seed=seed, chunk_size=37)
            variants = [("plain", data, s)]
            rng = np.random.RandomState(seed)
            if ctype == 3:
                n = min(1 << depth, 6)
                for label, alpha in [("trns", rng.randint(0, 256, n)), ("trns255", [255] * n),
                                     ("trns0", [0] * n)]:
                    d, _ = make_png(h, w, 3, depth, interlace, samples=s, seed=seed,
                                    trns=bytes(np.asarray(alpha, np.uint8)))
                    variants.append((label, d, s))
            if ctype in (0, 2):
                key = b"".join(struct.pack(">H", int(v)) for v in s[0, 0])
                d, _ = make_png(h, w, ctype, depth, interlace, samples=s, seed=seed, trns=key)
                variants.append(("trns", d, s))
            if ctype in (4, 6):
                s2 = s.copy()
                s2[..., -1] = (1 << depth) - 1
                variants.append(("opaque", make_png(h, w, ctype, depth, interlace, samples=s2,
                                                    seed=seed)[0], s2))
            for label, d, smp in variants:
                what = f"ct{ctype} d{depth} i{interlace} {h}x{w} {label}"
                if depth == 16 and interlace:
                    # libpng garbles multi-pass rows of 16-bit Adam7 images: hold
                    # the port to the reference's decode of the plain layout
                    plain = make_png(h, w, ctype, depth, 0, samples=smp, seed=seed,
                                     trns=None if label not in ("trns",) else
                                     b"".join(struct.pack(">H", int(v)) for v in smp[0, 0]))[0]
                    for ch in (1, 3):
                        want = ref_decode(ref, plain, ch)
                        got = port_decode(d, ch)
                        assert got is not None and got.shape == want.shape, what
                        assert np.array_equal(got, want), what
                    continue
                assert_same(d, what, ref_lib=ref)


def test_png_writers(ref):
    """PNGs as PIL and cv2 write them: every PIL mode the readers meet."""
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (31, 42, 3)).astype(np.uint8)
    ims = [Image.fromarray(rgb), Image.fromarray(rgb[..., 0]), Image.fromarray(rgb).convert("P"),
           Image.fromarray(rgb).convert("1"), Image.fromarray(rgb).convert("LA"),
           Image.fromarray(rgb).convert("RGBA"),
           Image.fromarray((rgb[..., 0].astype(np.int32) * 257), "I").convert("I;16")]
    for im in ims:
        for kw in ({}, {"optimize": True}, {"compress_level": 0}):
            b = io.BytesIO()
            im.save(b, "PNG", **kw)
            assert_same(b.getvalue(), f"PIL {im.mode} {kw}", ref_lib=ref)
    for img in (rgb, rgb[..., :1], (rgb.astype(np.uint16) * 257)):
        for lvl in (0, 3, 9):
            d = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, lvl])[1].tobytes()
            assert_same(d, f"cv2 {img.dtype} {img.shape} level {lvl}", ref_lib=ref)


def test_png_status_on_damage(ref):
    """Truncation anywhere, a bad CRC in each chunk, a bad Adler-32, extra
    compressed data, a missing IEND: the reference build's status, and its
    pixels where both decode."""
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG")
    sources = {"pil": b.getvalue(), "cv2": cv2.imencode(".png", img)[1].tobytes(),
               "adam7": make_png(30, 20, 0, 8, 1, seed=1)[0],
               "palette": make_png(9, 14, 3, 4, 0, seed=2, chunk_size=20)[0]}
    for name, data in sources.items():
        n = len(data)
        for cut in sorted({8, 12, 20, 33, 40, n // 4, n // 2} | set(range(n - 30, n))):
            assert_same(data[:cut], f"{name} cut {cut}/{n}", ref_lib=ref)
        chunks, pos = [], 8
        while pos < n:
            ln = struct.unpack(">I", data[pos: pos + 4])[0]
            chunks.append((data[pos + 4: pos + 8], data[pos + 8: pos + 8 + ln]))
            pos += 12 + ln
        idat = b"".join(c for t, c in chunks if t == b"IDAT")
        for fault in ("crc_IHDR", "crc_IDAT", "crc_PLTE", "crc_IEND", "adler", "no_adler",
                      "extra", "no_IEND"):
            z = idat
            if fault == "adler":
                z = z[:-1] + bytes([z[-1] ^ 1])
            elif fault == "no_adler":
                z = z[:-4]
            elif fault == "extra":
                z = z + b"\x00\x01\x02"
            out = b"\x89PNG\r\n\x1a\n"
            for t, c in chunks:
                if t == b"IDAT":
                    continue
                if t == b"IEND":
                    ck = chunk(b"IDAT", z)
                    out += ck[:-1] + bytes([ck[-1] ^ 1]) if fault == "crc_IDAT" else ck
                    if fault == "no_IEND":
                        break
                ck = chunk(t, c)
                if fault == f"crc_{t.decode()}":
                    ck = ck[:-1] + bytes([ck[-1] ^ 1])
                out += ck
            assert_same(out, f"{name} {fault}", ref_lib=ref)


# --------------------------------------------------------------------- JPEG

def _photo(h, w, c, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 7.0) * 60 + np.cos(y / 5.0) * 50 + 128
    return np.clip(np.stack([base + rng.randn(h, w) * 20 + 15 * k for k in range(c)], -1),
                   0, 255).astype(np.uint8)


SIZES = [(1, 1), (7, 13), (17, 9), (479, 641)]
CV2_SAMPLING = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def jpegs(kind: str):
    """(label, bytes) for one writer/sampling over the size, quality and
    progressive matrix (cv2 kinds with and without a restart interval)."""
    out = []
    for h, w in SIZES:
        for q in (50, 95):
            for prog in (False, True):
                if kind == "gray":
                    b = io.BytesIO()
                    Image.fromarray(_photo(h, w, 1, h)[..., 0]).save(b, "JPEG", quality=q,
                                                                     progressive=prog)
                    out.append((f"{h}x{w} q{q} p{int(prog)}", b.getvalue()))
                elif kind.startswith("pil"):
                    b = io.BytesIO()
                    Image.fromarray(_photo(h, w, 3, w)).save(
                        b, "JPEG", quality=q, progressive=prog,
                        subsampling={"pil444": 0, "pil422": 1, "pil420": 2}[kind])
                    out.append((f"{h}x{w} q{q} p{int(prog)}", b.getvalue()))
                else:
                    for rst in (0, 3):
                        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                  int(prog), cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[kind]]
                        d = cv2.imencode(".jpg", _photo(h, w, 3, q), params)[1].tobytes()
                        out.append((f"{h}x{w} q{q} p{int(prog)} rst{rst}", d))
    return out


@pytest.mark.parametrize("kind", ["gray", "pil444", "pil422", "pil420", "4:4:0", "4:1:1",
                                  "4:2:0"])
def test_jpeg_matrix(ref, kind):
    """Every size, quality and progression at scale_num 1..8, gray and RGB
    out: exact."""
    for label, data in jpegs(kind):
        assert_same(data, f"{kind} {label}", nums=range(1, 9), ref_lib=ref)


@pytest.mark.parametrize("kind", ["pil420", "4:2:0", "gray"])
def test_jpeg_truncated(ref, kind):
    """A file cut short: the Huffman decoder pads with zero bits and leaves
    the MCUs after the one that ran out at zero, the arithmetic decoder
    reads zero bytes; a progressive image whose coefficients are not all
    refined is block-smoothed. Baseline, progressive and their arithmetic
    transcodes (SOF9, SOF10): the reference's status and pixels."""
    for label, data in jpegs(kind):
        if "479x641" not in label:
            continue
        prog = " p1" in label
        codings = [("huffman", data, (8, 5, 2))]
        if "rst3" not in label:  # (a transcode drops the interval: it would repeat rst0)
            codings.append(("arith", transcode(ref, data, True, prog), (8, 2)))
        for coding, d, nums in codings:
            for frac in (0.02, 0.1, 0.35, 0.6, 0.9, 0.99):
                cut = d[: int(len(d) * frac)]
                assert_same(cut, f"{kind} {label} {coding} cut {frac}", nums=nums, ref_lib=ref)


def _segments(data: bytes):
    """The marker segments before the scan data: [(marker, payload)], rest."""
    out, pos = [], 2
    while True:
        m = data[pos + 1]
        ln = struct.unpack(">H", data[pos + 2: pos + 4])[0]
        out.append((m, data[pos + 4: pos + 2 + ln]))
        pos += 2 + ln
        if m == 0xDA:
            return out, data[pos:]


def _join(segs, rest):
    return b"\xff\xd8" + b"".join(bytes([0xFF, m]) + struct.pack(">H", len(p) + 2) + p
                                  for m, p in segs) + rest


def test_jpeg_markers_and_tables(ref):
    """The colour-space markers (JFIF, Adobe transform 0/1, 'RGB' component
    ids, none), libjpeg-turbo's default Huffman tables when a file has no
    DHT, and 16-bit quantization tables."""
    b = io.BytesIO()
    Image.fromarray(_photo(23, 37, 3, 1)).save(b, "JPEG", quality=90, subsampling=0)
    segs, rest = _segments(b.getvalue())
    no_app = [(m, p) for m, p in segs if m != 0xE0]
    sof = next(i for i, (m, _) in enumerate(no_app) if m == 0xC0)
    p = bytearray(no_app[sof][1])
    p[6], p[9], p[12] = 82, 71, 66  # component ids 'R', 'G', 'B'
    rgb_ids = list(no_app)
    rgb_ids[sof] = (0xC0, bytes(p))
    q = bytearray(rgb_ids[-1][1])  # the SOS names the components by id too
    q[1], q[3], q[5] = 82, 71, 66
    rgb_ids[-1] = (0xDA, bytes(q))
    adobe = lambda t: (0xEE, b"Adobe" + b"\x00\x64\x00\x00\x00\x00" + bytes([t]))
    cases = {"jfif": _join(segs, rest), "none": _join(no_app, rest),
             "rgb_ids": _join(rgb_ids, rest), "adobe0": _join([adobe(0)] + no_app, rest),
             "adobe1": _join([adobe(1)] + no_app, rest),
             "adobe2": _join([adobe(2)] + no_app, rest)}
    # the default tables: PIL writes the standard ones unless optimizing
    cases["no_dht"] = _join([(m, p) for m, p in segs if m != 0xC4], rest)
    # 16-bit quantization tables (precision nibble 1)
    dqt = []
    for m, p in segs:
        if m == 0xDB:
            q = b""
            i = 0
            while i < len(p):
                q += bytes([0x10 | p[i]]) + np.frombuffer(p[i + 1: i + 65], np.uint8).astype(
                    ">u2").tobytes()
                i += 65
            dqt.append((m, q))
        else:
            dqt.append((m, p))
    cases["dqt16"] = _join(dqt, rest)
    for name, d in cases.items():
        assert_same(d, name, nums=(8, 3), ref_lib=ref)
        assert port_decode(d, 3) is not None, name


def test_jpeg_unsupported_fail_cleanly(ref):
    """12-bit samples, lossless (SOF3) and a second frame header: the port
    fails with a nonzero status, as the reference does. A Huffman scan under
    an arithmetic frame header (SOF9) both decode, to the same bytes."""
    b = io.BytesIO()
    Image.fromarray(_photo(16, 16, 3, 2)).save(b, "JPEG", quality=90)
    data = b.getvalue()
    i = data.index(b"\xff\xc0")
    arith = data[:i + 1] + b"\xc9" + data[i + 2:]
    twelve = data[:i + 4] + b"\x0c" + data[i + 5:]
    lossless = data[:i + 1] + b"\xc3" + data[i + 2:]
    second_sof = data[:i] + data[i: i + 2 + struct.unpack(">H", data[i + 2: i + 4])[0]] + data[i:]
    for name, d in [("12-bit", twelve), ("lossless", lossless), ("second SOF", second_sof)]:
        for ch in (1, 3):
            assert port_decode(d, ch) is None, name
            assert ref_decode(ref, d, ch) is None, name
    with pytest.raises(IOError):
        native.decode_bytes(lossless, 3)
    assert ref_decode(ref, arith, 3) is not None
    assert_same(arith, "arith", nums=(8, 5, 1), ref_lib=ref)


# ------------------------------------------------------------ prepare_batch

def _batch_files(tmp: Path):
    """PNG and JPEG files of assorted sizes, colour, sampling and
    progression, one missing path and one corrupt file."""
    paths = []
    for i, (h, w) in enumerate([(53, 71), (200, 150), (64, 64), (317, 240), (20, 33)]):
        img = _photo(h, w, 3, i)
        p = tmp / f"p{i}.png"
        cv2.imwrite(str(p), img if i % 2 else img[..., 0])
        paths.append(p)
        j = tmp / f"j{i}.jpg"
        Image.fromarray(img if i % 2 else img[..., 0]).save(
            j, "JPEG", quality=80 + i, progressive=i == 3, subsampling=i % 3)
        paths.append(j)
    paths.append(tmp / "missing.png")
    bad = tmp / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0garbage")
    paths.append(bad)
    return [str(p) for p in paths]


def _ref_batch(lib, paths, S, ch, letterbox, pad, threads, dtype, fast_jpeg):
    n = len(paths)
    meta = np.empty((n, 5), np.float32)
    status = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.empty((n, S, S, ch), np.uint8 if dtype == "uint8" else np.float32)
    fn = lib.yst_prepare_batch_u8 if dtype == "uint8" else lib.yst_prepare_batch
    fn.restype = None
    fn(c_paths, n, S, ch, int(letterbox), ctypes.c_uint8(pad), threads, int(fast_jpeg),
       out.ctypes.data_as(ctypes.c_void_p), meta.ctypes.data_as(ctypes.c_void_p),
       status.ctypes.data_as(ctypes.c_void_p))
    return out, meta, status


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("letterbox", [False, True])
def test_prepare_batch_matches_reference(ref, tmp_path, dtype, letterbox):
    """``yst_prepare_batch[_u8]``: images, meta and status exact, fast_jpeg
    on and off, pad 114, 1 and 4 threads, 1 and 3 channels."""
    paths = _batch_files(tmp_path)
    for ch in (1, 3):
        for fast in (False, True):
            for threads in (1, 4):
                got = native.prepare_batch(paths, 64, channels=ch, letterbox=letterbox,
                                           pad_value=114, threads=threads, dtype=dtype,
                                           fast_jpeg=fast)
                want = _ref_batch(ref, paths, 64, ch, letterbox, 114, threads, dtype, fast)
                what = f"ch{ch} fast{fast} threads{threads}"
                np.testing.assert_array_equal(got[2], want[2], err_msg=what)
                ok = want[2] == 0
                assert ok.sum() == len(paths) - 2 and (want[2][-2:] != 0).all()
                np.testing.assert_array_equal(got[1][ok], want[1][ok], err_msg=what)
                np.testing.assert_array_equal(got[0][ok], want[0][ok], err_msg=what)


def test_library_names_no_codec_library():
    """The host library the port loads is built from the port's own sources."""
    native.load()
    assert all(str(p).startswith(str(REPO / "yolo_scratch_tpu_torch" / "csrc"))
               for p in native.SOURCES)
    assert native.LIBRARY.exists()


def test_png_gamma_chunk_is_not_read(ref):
    """The gAMA chunk is read (the name is the test's older claim, which no
    longer holds): a file that says it is linear light (1.0) is converted to
    sRGB as libpng converts it, by up to 72 levels, and the port's decode
    equals the reference's exactly."""
    data, _ = make_png(16, 32, 0, 8, samples=np.arange(512).reshape(16, 32, 1) % 256)
    with_gama = data[:33] + chunk(b"gAMA", struct.pack(">I", 100000)) + data[33:]
    for ch in (1, 3):
        np.testing.assert_array_equal(port_decode(with_gama, ch), ref_decode(ref, with_gama, ch))
        d = np.abs(port_decode(with_gama, ch).astype(int) - ref_decode(ref, data, ch)).max()
        assert d == 72
