"""Regenerate the host-codec fixtures in this directory and their digests.

    PYTHONPATH=. python tests/fixtures/host_codecs/make_fixtures.py   # from the repo root

The fixtures are files the card's machine cannot write (it has neither
libjpeg nor libpng): arithmetic-coded JPEGs (SOF9, SOF10) made as lossless
transcodes of Huffman files by the JAX tier's libjpeg-turbo, including four
1024x768 4:2:0 ones of the crater scene ``chip_smoke.host_files`` draws and
the Huffman source of the first; progressive JPEGs to cut short (block
smoothing); and PNGs with gAMA, sRGB, cHRM, iCCP and sBIT chunks.

``digests.json`` holds, for every fixture, every cut of it listed there,
channels 1 and 3 and ``scale_num`` 8, 5, 4, 2, 1 (PNGs: 8), the sha256 and
shape of the decode of the JAX tier's libraries, through
``tests/test_torch_host_codecs.py``'s ``REF_SHIM`` (null where they refuse the
file). ``tests/test_torch_host_codecs_arith.py`` rebuilds the digests and
requires them equal to the committed file; ``chip_smoke.py`` phase 16(b)
holds the port's decodes on the card to them.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
NUMS = (8, 5, 4, 2, 1)
CUTS = (0.1, 0.35, 0.6, 0.9)  # fractions of a progressive file kept


def key(name: str, cut: float | None, ch: int, num: int) -> str:
    return f"{name}|{'' if cut is None else cut}|{ch}|{num}"


def parse_key(k: str):
    name, cut, ch, num = k.split("|")
    return name, (float(cut) if cut else None), int(ch), int(num)


def fixture_bytes(name: str, cut: float | None = None) -> bytes:
    """A committed fixture, or its first ``cut`` of bytes."""
    data = (HERE / name).read_bytes()
    return data if cut is None else data[: int(len(data) * cut)]


def _reference():
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_host_codecs as T

    return T


def write_fixtures(ref) -> dict:
    """Write every fixture; -> {name: [cuts]}."""
    import cv2
    from PIL import Image, ImageCms

    T = _reference()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from test_torch_host_codecs_arith import ADOBE, DEGENERATE, gama, iccp, sbit, srgb, with_chunks

    files: dict[str, bytes] = {}
    cuts: dict[str, tuple] = {}
    photo = T._photo(37, 53, 3, 5)

    def pil(img, **kw) -> bytes:
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", **kw)
        return b.getvalue()

    # small arithmetic-coded JPEGs: every sampling kind, SOF9 and SOF10,
    # restart intervals, non-default DAC conditioning
    gray, s444 = pil(photo[..., 0], quality=90), pil(photo, quality=85, subsampling=0)
    s422, s420 = pil(photo, quality=85, subsampling=1), pil(photo, quality=85, subsampling=2)
    s440 = cv2.imencode(".jpg", photo, [cv2.IMWRITE_JPEG_QUALITY, 80,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])[1].tobytes()
    for name, src, prog, rst, dac in [
            ("arith_gray_seq.jpg", gray, False, 0, (0, 1, 5)),
            ("arith_gray_prog.jpg", gray, True, 0, (0, 1, 5)),
            ("arith_444_seq_rst2_dac.jpg", s444, False, 2, (2, 5, 2)),
            ("arith_422_prog.jpg", s422, True, 0, (0, 1, 5)),
            ("arith_420_seq.jpg", s420, False, 0, (0, 1, 5)),
            ("arith_420_prog_rst1_dac.jpg", s420, True, 1, (1, 3, 9)),
            ("arith_440_seq.jpg", s440, False, 0, (0, 1, 5))]:
        files[name] = T.transcode(ref, src, True, prog, rst, dac)
    # small progressive files to cut: Huffman and arithmetic
    files["huffman_420_prog.jpg"] = T.transcode(ref, s420, False, True)
    files["arith_420_prog_cut.jpg"] = T.transcode(ref, s420, True, True)
    cuts["huffman_420_prog.jpg"] = cuts["arith_420_prog_cut.jpg"] = CUTS
    # the crater scene at 1024x768: four arithmetic-coded, the first one's
    # Huffman source, and that source progressive (to cut)
    with tempfile.TemporaryDirectory() as tmp:
        scene = chip_smoke.host_files(Path(tmp), 4)["jpeg"]
        srcs = [Path(p).read_bytes() for p in scene]
    for i, src in enumerate(srcs):
        files[f"crater_arith_{i}.jpg"] = T.transcode(ref, src, True)
    files["crater_huffman_0.jpg"] = srcs[0]
    files["crater_prog_0.jpg"] = T.transcode(ref, srcs[0], False, True)
    cuts["crater_prog_0.jpg"] = CUTS
    # PNGs with colour chunks
    rgba, _ = T.make_png(24, 32, 6, 8, seed=1)
    rgb, _ = T.make_png(24, 32, 2, 8, seed=2)
    gray8, _ = T.make_png(24, 32, 0, 8, seed=3)
    rgb16, _ = T.make_png(24, 32, 2, 16, seed=4)
    pal, _ = T.make_png(24, 32, 3, 4, seed=5, trns=bytes([0, 90, 255, 200, 17]))
    g, a = np.meshgrid(np.arange(0, 256, 5), np.arange(0, 256, 5), indexing="ij")
    alpha_ramp, _ = T.make_png(52, 52, 6, 8, samples=np.stack([g, g // 2, 255 - g, a], -1))
    lab = ImageCms.ImageCmsProfile(ImageCms.createProfile("LAB")).tobytes()
    for name, base, chunks in [
            ("gray_gama100000.png", gray8, [gama(100000)]),
            ("rgb_gama80000.png", rgb, [gama(80000)]),
            ("rgba_gama50000.png", rgba, [gama(50000)]),
            ("rgba_srgb_stray_gama.png", rgba, [srgb(), gama(100000)]),
            ("rgb_chrm_adobe.png", rgb, [ADOBE]),
            ("rgb_chrm_degenerate_gama.png", rgb, [DEGENERATE, gama(100000)]),
            ("palette_trns_gama.png", pal, [gama(100000)]),
            ("rgb16_gama45455.png", rgb16, [gama(45455)]),
            ("rgb16_sbit10_adobe.png", rgb16, [sbit(10, 10, 9), ADOBE]),
            ("rgb_iccp_lab_gama.png", rgb, [iccp(lab), gama(100000)]),
            ("rgba_alpha_ramp.png", alpha_ramp, [])]:
        files[name] = with_chunks(base, chunks)
    for old in HERE.glob("*.jpg"):
        old.unlink()
    for old in HERE.glob("*.png"):
        old.unlink()
    for name, data in files.items():
        (HERE / name).write_bytes(data)
    return {name: list(cuts.get(name, ())) for name in sorted(files)}


def digests(ref, names: dict | None = None) -> dict:
    """The reference's decodes of the committed fixtures (``names``: the
    file list and cuts, else the committed ``digests.json``'s)."""
    T = _reference()
    if names is None:
        names = {n: v["cuts"] for n, v in
                 json.loads((HERE / "digests.json").read_text())["files"].items()}
    out = {"files": {}, "decodes": {}}
    for name, cut_list in sorted(names.items()):
        data = fixture_bytes(name)
        out["files"][name] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
                              "cuts": list(cut_list)}
        nums = (8,) if name.endswith(".png") else NUMS
        for cut in [None, *cut_list]:
            part = fixture_bytes(name, cut)
            for ch in (1, 3):
                for num in nums:
                    img = T.ref_decode(ref, part, ch, num)
                    out["decodes"][key(name, cut, ch, num)] = None if img is None else {
                        "shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    return out


def main() -> None:
    T = _reference()
    import ctypes

    with tempfile.TemporaryDirectory() as tmp:
        ref = T.bind(ctypes.CDLL(str(T.build_reference(Path(tmp)))))
        names = write_fixtures(ref)
        d = digests(ref, names)
    (HERE / "digests.json").write_text(json.dumps(d, indent=1, sort_keys=True) + "\n")
    total = sum(v["bytes"] for v in d["files"].values())
    print(f"{len(names)} fixtures, {total} bytes, {len(d['decodes'])} decodes in digests.json")


if __name__ == "__main__":
    main()
