"""The port's DICOM reader against the JAX package's, on the CPU.

Files are written by the port's ``data/dicom_writer.py`` (the writer the
card's ``dicom_serve`` phase uses, at 12 bits stored in 16) and, for predictors
2-7 of JPEG lossless and for a replicate run of RLE, by hand here. For each
transfer syntax, photometric interpretation and windowing case the port's
``read_dicom`` array and attributes and its ``dicom_to_uint8`` image are
bitwise the JAX package's; a ``.dcm`` list through both packages'
``ImageDataset`` gives bitwise batches (float eval transform, and the
uint8 batch of ``device_preproc``).
"""

import struct

import numpy as np
import pytest

from test_dicom import _encode_jpeg_lossless, _write_encapsulated
from vilmedic_torch.data import dicom as tdicom
from vilmedic_torch.data import dicom_codecs as tcodecs
from vilmedic_torch.data import dicom_writer as writer
from vilmedic_torch.data.image import ImageDataset as TImageDataset
from vilmedic_tpu.data import dicom as jdicom
from vilmedic_tpu.data.image import ImageDataset as JImageDataset


def _pixels(seed, rows=24, cols=20, signed=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols]
    img = 1800 + 900 * np.sin(yy / 5.0) * np.cos(xx / 7.0) + rng.integers(0, 64, (rows, cols))
    img = img.astype(np.int64) - (2048 if signed else 0)
    return img.astype(np.int16 if signed else np.uint16)


CASES = {
    "explicit_le": dict(syntax=tdicom.EXPLICIT_LE),
    "implicit_le": dict(syntax=tdicom.IMPLICIT_LE),
    "explicit_be": dict(syntax=tdicom.EXPLICIT_LE, big_endian=True),
    "jpeg_lossless_sv1": dict(syntax=tdicom.JPEG_LOSSLESS_70),
    "jpeg_lossless_fragments_bot": dict(syntax=tdicom.JPEG_LOSSLESS_70, fragments=3,
                                        offset_table=True),
    "rle": dict(syntax=tdicom.RLE_LOSSLESS),
    "rle_fragments": dict(syntax=tdicom.RLE_LOSSLESS, fragments=2),
    "monochrome1_window": dict(syntax=tdicom.EXPLICIT_LE, photometric="MONOCHROME1",
                               window=(1800, 1200)),
    "monochrome1_window_jpeg": dict(syntax=tdicom.JPEG_LOSSLESS_70,
                                    photometric="MONOCHROME1", window=(1700.5, 900)),
    "signed_rescale_window": dict(syntax=tdicom.IMPLICIT_LE, signed=True,
                                  rescale=(2.0, -100.0), window=(300, 2500)),
}


def _assert_same(path):
    t_arr, t_attrs = tdicom.read_dicom(str(path))
    j_arr, j_attrs = jdicom.read_dicom(str(path))
    assert t_arr.dtype == j_arr.dtype and t_arr.shape == j_arr.shape
    np.testing.assert_array_equal(t_arr, j_arr)
    assert t_attrs == j_attrs
    t_img, j_img = tdicom.dicom_to_uint8(str(path)), jdicom.dicom_to_uint8(str(path))
    assert t_img.dtype == j_img.dtype == np.uint8
    np.testing.assert_array_equal(t_img, j_img)
    return t_arr, t_img


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_dicom_bitwise_the_jax_package(tmp_path, case):
    spec = CASES[case]
    pixels = _pixels(len(case), signed=spec.get("signed", False))
    path = tmp_path / f"{case}.dcm"
    writer.write_dicom(str(path), pixels, **spec)
    arr, img = _assert_same(path)
    np.testing.assert_array_equal(arr, pixels)  # lossless: the written values
    assert img.max() == 255


@pytest.mark.parametrize("predictor", [2, 3, 4, 5, 6, 7])
def test_jpeg_lossless_predictors(tmp_path, predictor):
    pixels = _pixels(predictor, 13, 11)
    path = tmp_path / "jl.dcm"
    _write_encapsulated(str(path), [_encode_jpeg_lossless(pixels, 16, predictor)],
                        tdicom.JPEG_LOSSLESS_70, 13, 11)
    arr, _ = _assert_same(path)
    np.testing.assert_array_equal(arr, pixels)


def test_writer_matches_the_reference_encoder():
    """The port's vectorized SV1 encoder writes the bytes of the
    one-sample-at-a-time encoder of ``tests/test_dicom.py``."""
    pixels = _pixels(3, 31, 29)
    assert writer.jpeg_lossless_sv1(pixels) == _encode_jpeg_lossless(pixels, 16, 1)


def test_rle_replicate_runs(tmp_path):
    """Segments with replicate runs (PackBits -n) and the -128 no-op."""
    rows, cols = 6, 10
    msb = bytes([1] * 30 + list(range(30)))
    lsb = bytes([7] * 60)

    def seg(data):
        out = bytearray()
        i = 0
        while i < len(data):
            j = i
            while j < len(data) and j - i < 128 and data[j] == data[i]:
                j += 1
            if j - i >= 2:
                out += bytes([257 - (j - i)]) + data[i:i + 1]
            else:
                j = min(i + 1, len(data))
                out += bytes([0]) + data[i:j]
            i = j
        return bytes(out) + b"\x80"

    s0, s1 = seg(msb), seg(lsb)
    frame = struct.pack("<I", 2) + struct.pack("<15I", 64, 64 + len(s0), *([0] * 13)) + s0 + s1
    path = tmp_path / "rle.dcm"
    _write_encapsulated(str(path), [frame], tdicom.RLE_LOSSLESS, rows, cols)
    arr, _ = _assert_same(path)
    want = (np.frombuffer(msb, np.uint8).astype(np.uint16) << 8) | np.frombuffer(lsb, np.uint8)
    np.testing.assert_array_equal(arr, want.reshape(rows, cols))


def test_jpeg_baseline_through_pillow(tmp_path):
    import io

    from PIL import Image

    pixels = (_pixels(5, 16, 16) >> 4).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels, mode="L").save(buf, format="JPEG", quality=90)
    path = tmp_path / "jb.dcm"
    _write_encapsulated(str(path), [buf.getvalue()], "1.2.840.10008.1.2.4.50", 16, 16, bits=8)
    _assert_same(path)


def test_codec_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ rejects, or no g++, raises."""
    bad = tmp_path / "dicom_codecs.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(tcodecs, "SOURCE", bad)
    monkeypatch.setattr(tcodecs, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcodecs.build()
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tcodecs.build()


@pytest.mark.parametrize("device_preproc", [False, True])
def test_image_dataset_batches_bitwise(tmp_path, device_preproc):
    """Six ``.dcm`` files (three syntaxes, MONOCHROME1 windowed among them)
    through both packages' ``ImageDataset`` on the validate split."""
    paths = []
    for i, case in enumerate(("explicit_le", "jpeg_lossless_sv1", "rle",
                              "monochrome1_window", "implicit_le", "monochrome1_window_jpeg")):
        paths.append(str(tmp_path / f"{i}.dcm"))
        writer.write_dicom(paths[-1], _pixels(10 + i, 40, 36), **CASES[case])
    (tmp_path / "validate.image.tok").write_text("\n".join(paths) + "\n")
    kw = dict(root=str(tmp_path), file="image.tok", split="validate", ext=".dcm", resize=32,
              crop=24, device_preproc=device_preproc)
    tds, jds = TImageDataset(**kw), JImageDataset(**kw)
    t_batch = tds.get_collate_fn()([tds[i] for i in range(len(paths))])
    j_batch = jds.get_collate_fn()([jds[i] for i in range(len(paths))])
    if device_preproc:
        np.testing.assert_array_equal(t_batch["images_u8"].numpy(), j_batch["images_u8"])
    else:
        np.testing.assert_array_equal(t_batch["images"].permute(0, 2, 3, 1).numpy(),
                                      j_batch["images"])
    # the zoo's route: dataset.inference over the paths
    inf = tds.inference(paths[:2])
    key = "images_u8" if device_preproc else "images"
    np.testing.assert_array_equal(inf[key].numpy(), t_batch[key][:2].numpy())
