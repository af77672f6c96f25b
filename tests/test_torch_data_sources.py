"""The port's other data sources against the JAX package's, on the CPU.

- a custom transform registered under the ``transform`` kind of each
  package's registry (``custom_transform_train`` / ``_validate``): the
  split picks it, it takes the decoded RGB Pillow image, and its output
  goes through the same collate as the built-in transforms' (bitwise the
  JAX package's batches, NHWC there, NCHW here), the port's threaded loader
  included;
- ``hf_dataset`` with ``hf_local`` from a ``DatasetDict.save_to_disk``
  folder, with a dict filter (equality and membership): the sentences of a
  ``TextDataset`` and the images of an ``ImageDataset`` (paths under
  ``image_path``, and Pillow images stored in the dataset) equal the JAX
  package's, batches bitwise.
"""

import numpy as np
import pytest
from PIL import Image

from vilmedic_torch import registry as tregistry
from vilmedic_torch.data.image import ImageDataset as TImageDataset
from vilmedic_torch.data.loader import DataLoader as TDataLoader
from vilmedic_torch.data.text import TextDataset as TTextDataset
from vilmedic_tpu import registry as jregistry
from vilmedic_tpu.data.image import ImageDataset as JImageDataset
from vilmedic_tpu.data.text import TextDataset as JTextDataset


class GraySquare:
    """A deterministic custom transform: the centre square, resized to 20²,
    gray levels in [0, 1] repeated on 3 channels, channel-last f32."""

    def __call__(self, img):
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s))
        arr = np.asarray(img.resize((20, 20), Image.BILINEAR).convert("L"), np.float32) / 255.0
        return np.repeat(arr[:, :, None], 3, axis=2)


class Inverted(GraySquare):
    def __call__(self, img):
        return 1.0 - super().__call__(img)


for _registry in (tregistry, jregistry):
    for _cls in (GraySquare, Inverted):
        _registry.register("transform", f"test_sources_{_cls.__name__}")(_cls)


def _jpegs(folder, n, seed):
    rng = np.random.default_rng(seed)
    folder.mkdir(exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(str(folder / f"im{i}.png"))
        size = (28 + 2 * i, 24 + i)
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(paths[-1])
    return paths


@pytest.mark.parametrize("split", ["train", "validate"])
def test_custom_transform_by_split(tmp_path, split):
    paths = _jpegs(tmp_path / "images", 5, 1)
    (tmp_path / f"{split}.image.tok").write_text("\n".join(paths) + "\n")
    kw = dict(root=str(tmp_path), file="image.tok", split=split, ext=".png",
              custom_transform_train="test_sources_GraySquare",
              custom_transform_validate="test_sources_Inverted")
    tds, jds = TImageDataset(**kw), JImageDataset(**kw)
    assert type(tds.transform.fn).__name__ == ("GraySquare" if split == "train" else "Inverted")
    want = jds.get_collate_fn()([jds[i] for i in range(5)])["images"]
    got = tds.get_collate_fn()([tds[i] for i in range(5)])["images"]
    assert tuple(got.shape) == (5, 3, 20, 20)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the threaded loader: decode on the threads, the transform in finish
    loaded = list(TDataLoader(tds, batch_size=2, num_workers=2))
    np.testing.assert_array_equal(
        np.concatenate([b["images"].numpy() for b in loaded]), got.numpy())


def _save_dataset(path, rows_by_split, features=None):
    import datasets

    datasets.DatasetDict({
        split: datasets.Dataset.from_dict(rows, features=features)
        for split, rows in rows_by_split.items()
    }).save_to_disk(str(path))
    return str(path)


REPORTS = {
    "findings": ["The lungs are clear.", "Small left effusion!", "Heart size is normal.",
                 "Mild edema; no consolidation.", "Stable cardiomegaly."],
    "impression": ["No acute disease.", "Left effusion.", "Normal heart.", "Mild edema.",
                   "Cardiomegaly, stable."],
    "view": ["PA", "AP", "LATERAL", "PA", "AP"],
    "site": ["a", "a", "b", "b", "a"],
}


@pytest.mark.parametrize("hf_filter", [None, {"view": ["PA", "AP"]},
                                       [{"view": ["PA", "AP"]}, {"site": "a"}]])
def test_hf_dataset_text(tmp_path, hf_filter):
    path = _save_dataset(tmp_path / "reports", {"train": REPORTS, "validate": REPORTS})
    (tmp_path / "ckpt").mkdir()
    kw = dict(split="train", ckpt_dir=str(tmp_path / "ckpt"), hf_dataset=path,
              hf_local=True, hf_field="impression", hf_filter=hf_filter,
              processing="r2gen_clean_report", tokenizer_max_len=12, source="tgt")
    jds = JTextDataset(**kw)
    (tmp_path / "ckpt" / "vocab.tgt").unlink()
    tds = TTextDataset(**kw)
    assert tds.sentences == jds.sentences
    assert len(tds) == {None: 5, "dict": 4, "list": 3}[
        None if hf_filter is None else type(hf_filter).__name__]
    batch = [tds[i] for i in range(len(tds))]
    got = tds.get_collate_fn()(batch)
    want = jds.get_collate_fn()([jds[i] for i in range(len(jds))])
    np.testing.assert_array_equal(got["input_ids"].numpy(), np.asarray(want["input_ids"]))
    np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                  np.asarray(want["attention_mask"]))


@pytest.mark.parametrize("stored", ["paths", "pillow"])
def test_hf_dataset_images(tmp_path, stored):
    import datasets

    paths = _jpegs(tmp_path / "images", 4, 2)
    rows = {"view": ["PA", "AP", "LATERAL", "PA"]}
    if stored == "paths":
        rows["images_path"] = [[f"images/im{i}.png"] for i in range(4)]
        rows["images_path"][1].append("images/im3.png")  # two images in a row
        features = None
        image_path = str(tmp_path)
    else:
        rows["images_path"] = [Image.open(p) for p in paths]
        features = datasets.Features({"view": datasets.Value("string"),
                                      "images_path": datasets.Image()})
        image_path = None
    path = _save_dataset(tmp_path / "cxr", {"validate": rows}, features)
    kw = dict(split="validate", hf_dataset=path, hf_local=True, hf_field="images_path",
              hf_filter={"view": ["PA", "AP"]}, image_path=image_path, ext=".png",
              resize=24, crop=20)
    tds, jds = TImageDataset(**kw), JImageDataset(**kw)
    assert len(tds) == len(jds) == 3
    want = jds.get_collate_fn()([jds[i] for i in range(3)])["images"]
    got = tds.get_collate_fn()([tds[i] for i in range(3)])["images"]
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_hf_dataset_with_a_file_raises(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        TImageDataset(root=str(tmp_path), file="x", split="train", hf_dataset="y")
