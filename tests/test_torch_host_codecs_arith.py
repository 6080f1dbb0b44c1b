"""The port's host codecs against the JAX package's native tier beyond plain
Huffman JPEGs and chunk-free PNGs: arithmetic-coded JPEGs (SOF9, SOF10),
libpng's colour chunks (gAMA, sRGB, cHRM, iCCP, sBIT) and its table sRGB
encoder, and the committed fixtures of ``tests/fixtures/host_codecs`` that
the card's smoke run checks.

The reference is the one ``tests/test_torch_host_codecs.py`` builds: the JAX
tier's ``csrc/yst_host.cpp`` over libpng, libjpeg-turbo and zlib, with
``REF_SHIM``. Arithmetic-coded files are lossless transcodes of Huffman ones
made with that same libjpeg (``ref_transcode``, as ``jpegtran -arithmetic``
makes them), so each also decodes equal to its Huffman source.

Stated tolerance: exact, every byte and every status.
"""

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image, ImageCms

from test_torch_host_codecs import (  # noqa: F401  (fixtures)
    PNG_KINDS, _photo, chunk, make_png, one_torch_thread, port_decode, ref, ref_decode,
    ref_so, transcode)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "host_codecs"


def _same(ref_lib, data: bytes, what: str, nums=(8,), chs=(1, 3), twin: bytes = None):
    """The port's decode equals the reference's (status, shape, bytes) and,
    where ``twin`` is given, the reference's decode of ``twin``."""
    for ch in chs:
        for num in nums:
            a, b = ref_decode(ref_lib, data, ch, num), port_decode(data, ch, num)
            tag = f"{what} ch{ch} {num}/8"
            assert (a is None) == (b is None), f"{tag}: status ref {a is None}, port {b is None}"
            if twin is not None:
                t = ref_decode(ref_lib, twin, ch, num)
                assert a is not None and np.array_equal(a, t), f"{tag}: differs from its twin"
            if a is not None:
                assert a.shape == b.shape and np.array_equal(a, b), f"{tag}: bytes differ"


# ---------------------------------------------------------------- JPEG

def huffman_sources(kind: str, sizes):
    """(label, baseline Huffman JPEG) of one sampling kind."""
    out = []
    for h, w in sizes:
        img = _photo(h, w, 3, h * w)
        if kind == "gray":
            b = io.BytesIO()
            Image.fromarray(img[..., 0]).save(b, "JPEG", quality=90)
            out.append((f"{h}x{w}", b.getvalue()))
        elif kind.startswith("pil"):
            b = io.BytesIO()
            Image.fromarray(img).save(b, "JPEG", quality=85,
                                      subsampling={"pil444": 0, "pil422": 1, "pil420": 2}[kind])
            out.append((f"{h}x{w}", b.getvalue()))
        else:
            flag = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                    "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[kind]
            d = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])[1]
            out.append((f"{h}x{w}", d.tobytes()))
    return out


# (progressive, restart interval, DAC (L, U, Kx)): SOF9 and SOF10, with and
# without restarts, libjpeg's default conditioning and another
ARITH_VARIANTS = [(False, 0, (0, 1, 5)), (True, 0, (0, 1, 5)), (False, 2, (2, 5, 2)),
                  (True, 1, (1, 3, 9))]


@pytest.mark.parametrize("kind", ["gray", "pil444", "pil422", "pil420", "4:4:0", "4:1:1"])
def test_arith_matrix(ref, kind):
    """Every sampling kind, odd sizes, SOF9 and SOF10, restart intervals and
    DAC conditioning, scale_num 1..8, gray and RGB out: the port equals the
    reference, and the reference's decode equals the Huffman source's."""
    small = huffman_sources(kind, [(1, 1), (7, 13), (17, 9), (37, 53)])
    for label, src in small:
        for prog, rst, dac in ARITH_VARIANTS:
            a = transcode(ref, src, True, prog, rst, dac)
            assert a[2:].find(b"\xff\xca" if prog else b"\xff\xc9") >= 0
            _same(ref, a, f"{kind} {label} p{int(prog)} rst{rst} dac{dac}", nums=range(1, 9),
                  twin=src)
    (label, src), = huffman_sources(kind, [(479, 641)])
    for prog, rst, dac in ARITH_VARIANTS[:2]:
        _same(ref, transcode(ref, src, True, prog, rst, dac), f"{kind} {label} p{int(prog)}",
              nums=(8, 5, 1), twin=src)


def test_arith_corrupt_statistics(ref):
    """Arithmetic data the decoder cannot make sense of (a Huffman file's
    scan relabelled SOF9/SOF10, and one with its bytes reversed): libjpeg
    warns and gives up on the rest of the restart interval; the port too."""
    b = io.BytesIO()
    Image.fromarray(_photo(40, 56, 3, 9)).save(b, "JPEG", quality=90)
    data = b.getvalue()
    i = data.index(b"\xff\xc0")
    for sof in (b"\xc9", b"\xca"):
        d = data[:i + 1] + sof + data[i + 2:]
        _same(ref, d, f"relabelled {sof.hex()}", nums=(8, 3))
    a = transcode(ref, data, True, False, 3)
    sos = a.index(b"\xff\xda")
    body = a[sos + 14:-2]
    _same(ref, a[:sos + 14] + body[::-1].replace(b"\xff", b"\xfe") + a[-2:], "reversed")


# ----------------------------------------------------------------- PNG

def with_chunks(data: bytes, chunks, before: bytes = None) -> bytes:
    """``chunks`` inserted right after IHDR, or before the first ``before``."""
    i = 33 if before is None else data.index(before) - 4
    return data[:i] + b"".join(chunks) + data[i:]


def gama(v: int) -> bytes:
    return chunk(b"gAMA", struct.pack(">I", v))


def srgb(intent: int = 0) -> bytes:
    return chunk(b"sRGB", bytes([intent]))


def chrm(white, red, green, blue) -> bytes:
    return chunk(b"cHRM", struct.pack(">8I", *white, *red, *green, *blue))


def sbit(*bits) -> bytes:
    return chunk(b"sBIT", bytes(bits))


def iccp(profile: bytes, name: bytes = b"icc") -> bytes:
    return chunk(b"iCCP", name + b"\0\0" + zlib.compress(profile))


ADOBE = chrm((31270, 32900), (64000, 33000), (21000, 71000), (15000, 6000))
SRGB_ENDPOINTS = chrm((31270, 32900), (64000, 33000), (30000, 60000), (15000, 6000))
DEGENERATE = chrm((31270, 32900), (30000, 60000), (30000, 60000), (15000, 6000))

# gAMA at 1.0, 0.8, 45455 +-1% and +-10% and 2.2; sRGB with a stray gAMA on
# either side; cHRM (Adobe RGB, sRGB's, degenerate, all zero) alone and with
# gAMA; duplicate and out-of-range chunks, which libpng's colorspace marks
# invalid (the chunks after them are then ignored)
COLOUR_CHUNKS = {
    "g1.0": [gama(100000)], "g0.8": [gama(80000)], "g45000": [gama(45000)],
    "g45910": [gama(45910)], "g40910": [gama(40910)], "g50000": [gama(50000)],
    "g2.2": [gama(220000)], "srgb": [srgb()], "g1+srgb": [gama(100000), srgb(3)],
    "srgb+g1": [srgb(), gama(100000)], "srgb+g45000": [srgb(1), gama(45000)],
    "adobe": [ADOBE], "adobe+g1": [ADOBE, gama(100000)], "srgb_endpoints": [SRGB_ENDPOINTS],
    "degenerate": [DEGENERATE], "degenerate+g1": [DEGENERATE, gama(100000)],
    "zero_chrm": [chrm((0, 0), (0, 0), (0, 0), (0, 0))], "srgb+adobe": [srgb(), ADOBE],
    "adobe+srgb": [ADOBE, srgb()], "g0+g1": [gama(0), gama(100000)],
    "g0.8+g1": [gama(80000), gama(100000)], "srgb9+g1": [srgb(9), gama(100000)],
    "srgb+srgb+g1": [srgb(), srgb(), gama(100000)],
}


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_colour_chunks(ref, ctype, depth):
    """gAMA, sRGB and cHRM on every colour type and depth, plain and
    interlaced, with tRNS (palette alpha or a key colour) where the type
    takes it, and a gAMA after PLTE (out of place, ignored): exact."""
    for interlace in ((0,) if depth == 16 else (0, 1)):
        seed = 10 * ctype + depth
        data, s = make_png(7, 13, ctype, depth, interlace, seed=seed)
        bases = {"plain": data}
        rng = np.random.RandomState(depth)
        if ctype == 3:
            n = min(1 << depth, 6)
            bases["trns"] = make_png(7, 13, 3, depth, interlace, samples=s, seed=seed,
                                     trns=bytes(rng.randint(0, 256, n).astype(np.uint8)))[0]
            bases["trns255"] = make_png(7, 13, 3, depth, interlace, samples=s, seed=seed,
                                        trns=bytes([255] * n))[0]
        if ctype in (0, 2):
            key = b"".join(struct.pack(">H", int(v)) for v in s[0, 0])
            bases["trns"] = make_png(7, 13, ctype, depth, interlace, samples=s, seed=seed,
                                     trns=key)[0]
        for bname, b in bases.items():
            for cname, chunks in COLOUR_CHUNKS.items():
                _same(ref, with_chunks(b, chunks), f"ct{ctype} d{depth} i{interlace} {bname} "
                                                   f"{cname}")
            if ctype == 3:
                _same(ref, with_chunks(b, [gama(100000)], b"IDAT"), f"ct3 d{depth} {bname} "
                                                                     "gAMA after PLTE")


def test_png_gamma_moves_pixels(ref):
    """The colour chunks are read: gAMA 1.0 moves an 8-bit file by tens of
    levels, gAMA 45455 makes a 16-bit file sRGB, Adobe RGB end points move
    RGB -> gray, and the port follows each move exactly."""
    rgba, _ = make_png(16, 32, 6, 8, seed=1)
    rgb16, _ = make_png(16, 32, 2, 16, seed=2)
    rgb, _ = make_png(16, 32, 2, 8, seed=3)
    for base, chunks, ch in [(rgba, [gama(100000)], 3), (rgb16, [gama(45455)], 3),
                             (rgb, [ADOBE], 1)]:
        moved = with_chunks(base, chunks)
        a, b = ref_decode(ref, base, ch), ref_decode(ref, moved, ch)
        assert np.abs(a.astype(int) - b.astype(int)).max() > 10
        assert np.array_equal(port_decode(moved, ch), b)


def _profiles():
    """ICC profiles littlecms writes here, and damaged copies of one."""
    good = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    lab = ImageCms.ImageCmsProfile(ImageCms.createProfile("LAB")).tobytes()

    def patch(off, b):
        p = bytearray(good)
        p[off: off + len(b)] = b
        return bytes(p)

    return {"srgb_lcms": good, "lab": lab, "len100": patch(0, struct.pack(">I", 100)),
            "len_huge": patch(0, struct.pack(">I", 9000000)),
            "len_odd": patch(0, struct.pack(">I", len(good) + 1)), "gray_space": patch(16, b"GRAY"),
            "bad_magic": patch(36, b"xxxx"), "abstract": patch(12, b"abst"),
            "bad_pcs": patch(20, b"RGB "), "intent9": patch(64, struct.pack(">I", 9)),
            "tags_huge": patch(128, struct.pack(">I", 100000)), "cut131": good[:131],
            "cut200": good[:200], "garbage": struct.pack(">I", 592) + b"garbage" * 30}


def test_png_iccp_and_sbit(ref):
    """iCCP: a profile libpng accepts changes no pixel; one it rejects
    (reads, then fails its checks) invalidates the colour chunks after it;
    one too short to hold a zlib stream is ignored. sBIT: the 16-bit gamma
    tables keep the significant bits it gives. Gray, RGB, RGBA and 16-bit
    files, with a gAMA, cHRM or sRGB after the chunk under test: exact."""
    profiles = _profiles()
    for ctype, depth in [(0, 8), (2, 8), (6, 8), (0, 16), (2, 16), (3, 8), (4, 16)]:
        data, _ = make_png(7, 13, ctype, depth, seed=ctype + depth)
        for pname, prof in profiles.items():
            for after in ([gama(100000)], [ADOBE], [srgb()], [iccp(profiles["srgb_lcms"])]):
                _same(ref, with_chunks(data, [iccp(prof)] + after), f"ct{ctype} d{depth} {pname}")
        for kw in (b"", b"k" * 79, b"k" * 80):
            body = kw + b"\0\0" + zlib.compress(profiles["srgb_lcms"])
            _same(ref, with_chunks(data, [chunk(b"iCCP", body), gama(100000)]), f"keyword {len(kw)}")
        bad_crc = iccp(profiles["lab"])
        _same(ref, with_chunks(data, [bad_crc[:-1] + bytes([bad_crc[-1] ^ 1]), gama(100000)]),
              "iCCP with a bad CRC")
        nch = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[ctype]
        for bits in (1, 4, 8, 10, 11, 12, 15, 16, 17):
            for after in ([], [gama(100000)], [gama(45455)], [ADOBE]):
                _same(ref, with_chunks(data, [sbit(*[bits] * nch)] + after),
                      f"ct{ctype} d{depth} sBIT {bits}")


def test_srgb_encoder_table(ref):
    """Colour + partial alpha -> gray runs libpng's 512-segment sRGB encoder
    (png_sRGB_base / png_sRGB_delta) on sRGB-table products: every gray
    level at every alpha, 8- and 16-bit, exact."""
    g, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for depth, scale in ((8, 1), (16, 257)):
        px = np.stack([g, g, g, a], -1) * scale
        data, _ = make_png(256, 256, 6, depth, samples=px, seed=0)
        _same(ref, data, f"gray x alpha, {depth}-bit", chs=(1,))


# ------------------------------------------------------------ fixtures

def test_fixture_digests_are_the_references(ref):
    """``tests/fixtures/host_codecs/digests.json`` is what the reference
    decodes the committed fixtures to (rebuilt here with ``REF_SHIM``), and
    the port decodes every fixture, cut and scale to the same bytes."""
    sys.path.insert(0, str(FIXTURES))
    import make_fixtures

    committed = json.loads((FIXTURES / "digests.json").read_text())
    rebuilt = make_fixtures.digests(ref)
    assert rebuilt == committed
    for key, want in committed["decodes"].items():
        name, cut, ch, num = make_fixtures.parse_key(key)
        data = make_fixtures.fixture_bytes(name, cut)
        got = port_decode(data, ch, num)
        if want is None:
            assert got is None, key
        else:
            assert got is not None and list(got.shape) == want["shape"], key
            assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], key


def test_block_cap_fails_cleanly():
    """A deliberate difference (``ROADMAP.md`` section 3): the port decodes a
    whole file's coefficients first and refuses one of more than 2^24
    blocks (here 20000x20000 4:4:4, 18.75 M blocks), where libjpeg would
    decode a single-scan file row by row. The port fails at once, without
    allocating; the reference is not run (it would decode 400 M pixels)."""
    b = io.BytesIO()
    Image.fromarray(_photo(16, 16, 3, 1)).save(b, "JPEG", quality=90, subsampling=0)
    data = b.getvalue()
    i = data.index(b"\xff\xc0")
    huge = data[:i + 5] + struct.pack(">HH", 20000, 20000) + data[i + 9:]
    for ch in (1, 3):
        assert port_decode(huge, ch) is None
    ok = data[:i + 5] + struct.pack(">HH", 2000, 2000) + data[i + 9:]  # 0.19 M blocks
    assert port_decode(ok, 3).shape == (2000, 2000, 3)
