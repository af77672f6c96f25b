"""Image dataset: decode, transforms and collation (port of ``data/image.py``).

Images are read from ``{root}/{split}.{file}``: comma-separated paths per
line (a sample's images), or a ``.npy`` array of images, one per sample; or
from the ``hf_field`` of an ``hf_dataset`` (:mod:`.hf_plumbing`: paths under
``image_path``, or Pillow images). :func:`open_image` decodes a JPEG, PNG or
DICOM (``.dcm``, through :func:`.dicom.dicom_to_uint8`) to RGB and resizes
it with PIL's bilinear filter, as the JAX package does (Pillow is imported
inside the decode functions only); ``.npy`` images are used as they are. A
``custom_transform_train`` / ``custom_transform_validate`` names a
``transform`` of the port's registry (:class:`CustomTransform`), picked by
split before the built-in ones. The built-in transforms, on uint8 HWC
arrays, are the JAX package's four:

- host float (``device_preproc: false``): train resizes the smaller edge to
  ``resize``, takes a random ``crop`` square and a random horizontal flip,
  then scales to [0, 1] and normalizes with the ImageNet statistics; eval
  resizes to (``crop``, ``crop``) and normalizes;
- ``device_preproc: true``: the host keeps uint8 (train: the centre
  ``resize`` square and a random flip, then the collate's random crop;
  eval: the (``crop``, ``crop``) resize), and :func:`finalize_device_preproc`
  normalizes on the device through the crop+normalize kernel with zero
  offsets.

Random crops and flips come from one ``np.random.Generator`` seeded with the
loader's seed (the JAX package draws them from unseeded generators), in the
JAX package's order: per sample top, left, flip (float) or flip (uint8),
then per batch the collate's tops and lefts. Items split into
:meth:`ImageDataset.decode`, which draws nothing, and
:meth:`ImageDataset.finish`, which draws, so that a threaded loader can
decode in parallel and draw in batch order: the same seed gives the same
batches for any ``num_workers``; a sample's images draw in their order.

The float collate (:func:`vilmedic_collate`) stacks channel-last arrays and
moves the channels once to where the port's towers take them: (B, C, H, W),
or (B, C, D, H, W) for ``.npy`` volumes. With ``multi_image`` N above 1 it
keeps each sample's first N images, pads shorter samples with zero images
and returns (B, N, C, H, W) with ``images_mask`` (B, N), True where an
image's values do not sum to 0 (so an all-zero real image is masked too, as
in the JAX package). The uint8 collate keeps (B, crop, crop, 3), the
kernel's input layout; it takes one image per sample (``device_preproc``
with ``multi_image`` above 1 raises, as JAX asserts).

``inference_only`` (the zoo's mode) reads no image list: the dataset keeps
its transforms for :meth:`ImageDataset.inference`.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..registry import register
from .utils import load_file

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def open_pil(image, ext: str):
    """Decode one JPEG, PNG or DICOM file (or take a Pillow image, as an
    ``hf_dataset`` holds them) to an RGB Pillow image. A ``.dcm`` goes
    through :func:`.dicom.dicom_to_uint8` first, as in the JAX package."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # tolerate truncated files, as the JAX package
    Image.MAX_IMAGE_PIXELS = None
    if isinstance(image, Image.Image):
        return image if image.mode == "RGB" else image.convert("RGB")
    if ext == ".dcm":
        from .dicom import dicom_to_uint8

        return Image.fromarray(dicom_to_uint8(image)).convert("RGB")
    if ext not in (".jpg", ".jpeg", ".png"):
        raise NotImplementedError(f"image extension {ext} is not implemented")
    with Image.open(image) as im:
        return im.convert("RGB")


def open_image(image, ext: str, size=None, pil: bool = False):
    """Decode one image. JPEG/PNG/DICOM: RGB uint8 (H, W, 3), resized with
    PIL's bilinear filter when ``size`` is given (torchvision ``Resize``: an
    int sets the smaller edge, a pair the exact (h, w)), or with ``pil`` the
    RGB Pillow image as decoded (what a custom transform takes). ``.npy``:
    the array as it is (a path is loaded)."""
    if ext in (".npy", ".npz"):
        return np.asarray(np.load(image) if isinstance(image, str) else image)
    from PIL import Image

    img = open_pil(image, ext)
    if pil:
        return img
    if isinstance(size, (tuple, list)):
        img = img.resize((int(size[1]), int(size[0])), Image.BILINEAR)
    elif size is not None:
        w, h = img.size
        if w <= h:
            new_w, new_h = size, max(1, int(round(h * size / w)))
        else:
            new_w, new_h = max(1, int(round(w * size / h))), size
        img = img.resize((new_w, new_h), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> [0, 1] -> ImageNet-normalized f32, in the JAX package's
    f32 operations."""
    arr = np.asarray(arr, dtype=np.float32) / 255.0
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


class TrainTransform:
    """Resize(resize) -> RandomCrop(crop) -> RandomHorizontalFlip -> Normalize."""

    def __init__(self, resize: int, crop: int, rng: np.random.Generator):
        self.size, self.crop, self.rng = resize, crop, rng

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        top = int(self.rng.integers(0, max(h - self.crop, 0) + 1))
        left = int(self.rng.integers(0, max(w - self.crop, 0) + 1))
        arr = arr[top: top + self.crop, left: left + self.crop]
        if self.rng.random() < 0.5:
            arr = arr[:, ::-1]
        return normalize(arr)


class EvalTransform:
    """Resize((crop, crop)) -> Normalize."""

    def __init__(self, crop: int):
        self.size = (crop, crop)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return normalize(arr)


class TrainTransformU8:
    """The host half of the device preprocessing in training: the smaller
    edge resized to ``resize``, the centre square, a random flip, uint8."""

    def __init__(self, resize: int, rng: np.random.Generator):
        self.size, self.rng = resize, rng

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        top, left = (h - self.size) // 2, (w - self.size) // 2
        arr = arr[top: top + self.size, left: left + self.size]
        if self.rng.random() < 0.5:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)


class EvalTransformU8:
    """The host half of the device preprocessing in eval: the exact
    (crop, crop) resize, uint8."""

    def __init__(self, crop: int):
        self.size = (crop, crop)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(arr)


class ArrayTransform:
    """``.npy`` images: f32 as they are."""

    size = None

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr, dtype=np.float32)


class CustomTransform:
    """A ``transform`` registered in the port's registry (``@register(
    "transform")``), built with no argument: it takes the decoded RGB Pillow
    image, as in the JAX package, and returns a channel-last array that the
    float collate takes as it takes the built-in transforms' output."""

    size = None
    pil = True

    def __init__(self, name: str):
        from .. import registry

        self.fn = registry.get("transform", name)()

    def __call__(self, img):
        return self.fn(img)


def get_transforms(split: str, resize: int, crop: int, rng: np.random.Generator,
                   ext: str = ".jpg", called_by_ensemblor: bool = False,
                   device_preproc: bool = False, custom_transform_train=None,
                   custom_transform_validate=None):
    """The split's transform; a custom one, by its registry name, first
    (``custom_transform_train`` for the train split, ``_validate`` for the
    others), as the JAX package picks them."""
    if called_by_ensemblor:
        split = "validate"
    if custom_transform_train is not None and split == "train":
        return CustomTransform(custom_transform_train)
    if custom_transform_validate is not None and split != "train":
        return CustomTransform(custom_transform_validate)
    if ext in (".npy", ".npz"):
        return ArrayTransform()
    if device_preproc:
        return TrainTransformU8(resize, rng) if split == "train" else EvalTransformU8(crop)
    return TrainTransform(resize, crop, rng) if split == "train" else EvalTransform(crop)


def read_images(root: str, split: str, file: str) -> List[List]:
    """Per-line image paths (one per sample), or the images of a ``.npy``
    array."""
    file_path = os.path.join(root, split + "." + file)
    if ".npy" in file_path:
        return [[x] for x in np.load(file_path)]
    images = []
    for line in load_file(file_path):
        paths = [p.strip() for p in line.split(",")]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(f"image path does not exist: {p}")
        images.append(paths)
    return images


def vilmedic_collate(batch, multi_image: Optional[int] = None):
    """Float images of the items' ``image`` lists: ``{"images"}``, channels
    moved next to the batch axis, for one image per sample (``multi_image``
    None or 1); else ``{"images", "images_mask"}`` (module doc)."""
    if not multi_image or multi_image == 1:
        images = np.stack([np.asarray(s["image"][0]) for s in batch]).astype(np.float32)
        return {"images": torch.from_numpy(images).movedim(-1, 1).contiguous()}
    images, masks = [], []
    for sample in batch:
        ims = [np.asarray(im, dtype=np.float32) for im in sample["image"]][:multi_image]
        while len(ims) < multi_image:
            ims.append(np.zeros_like(ims[0]))
        stacked = np.stack(ims)
        masks.append(stacked.reshape(len(ims), -1).sum(axis=1) != 0)
        images.append(stacked)
    images = torch.from_numpy(np.stack(images).astype(np.float32)).movedim(-1, 2).contiguous()
    return {"images": images, "images_mask": torch.from_numpy(np.stack(masks))}


def finalize_device_preproc(batch, crop: int):
    """Turn a device-preproc batch (``images_u8`` (B, R, R, 3) uint8 plus
    ``preproc_tops``/``preproc_lefts``) into normalized ``images``
    (B, 3, crop, crop) f32 on the batch's device; a batch without
    ``images_u8`` passes through unchanged."""
    if "images_u8" not in batch:
        return batch
    from ..ops.image_preproc import crop_normalize

    batch = dict(batch)
    images_u8 = batch.pop("images_u8")
    tops = batch.pop("preproc_tops")
    lefts = batch.pop("preproc_lefts")
    batch["images"] = crop_normalize(images_u8, tops, lefts, crop)
    return batch


def prepare_batch(batch, dataset):
    """Run a dataset's pending device preprocessing on a batch that is
    already on its device."""
    image_ds = getattr(dataset, "image", None)
    if image_ds is not None and image_ds.device_preproc:
        return finalize_device_preproc(batch, image_ds.crop)
    return batch


@register("dataset")
class ImageDataset:
    def __init__(self, root=None, file=None, split=None, image_path=None, resize=256, crop=224,
                 ext=".jpg", multi_image=None, called_by_ensemblor=None, device_preproc=False,
                 seed: int = 0, custom_transform_train=None, custom_transform_validate=None,
                 hf_dataset=None, hf_field=None, hf_local=None, hf_filter=None,
                 inference_only: bool = False, **kwargs):
        if inference_only:  # the zoo's mode: the transforms only, no data file
            file, hf_dataset = None, None
        if split is None:
            raise ValueError("split cannot be None")
        if file is not None and hf_dataset is not None:
            raise ValueError("give a data file or an hf_dataset, not both")
        if device_preproc and (multi_image or 0) > 1:
            raise ValueError("device_preproc does not support multi_image yet")
        self.root = root
        self.file = file
        self.split = split
        self.image_path = image_path
        self.resize = int(resize)
        self.crop = int(crop)
        self.ext = ext
        self.multi_image = multi_image or 0
        self.device_preproc = bool(device_preproc)
        self.rng = np.random.default_rng(seed)
        self.images: Optional[List[List]] = None
        if file is not None:
            self.images = read_images(root, split, file)
        if hf_dataset is not None:
            from .hf_plumbing import load_hf_images

            self.images = load_hf_images(hf_dataset, hf_local, hf_filter, hf_field, split,
                                         image_path)
        self.transform = get_transforms(split, self.resize, self.crop, self.rng, self.ext,
                                        bool(called_by_ensemblor), self.device_preproc,
                                        custom_transform_train, custom_transform_validate)

    def __len__(self):
        return len(self.images or [])

    def _open(self, image):
        return open_image(image, self.ext, self.transform.size,
                          pil=getattr(self.transform, "pil", False))

    def decode(self, index):
        """The item's images, decoded and resized; no random draw."""
        return [self._open(im) for im in self.images[index]]

    def finish(self, decoded):
        """The transform of decoded images, with its random draws."""
        return {"image": [self.transform(arr) for arr in decoded]}

    def __getitem__(self, index):
        return self.finish(self.decode(index))

    def inference(self, image):
        """A batch from image paths: one per sample, or a list per sample
        (the JAX package's zoo API)."""
        samples = image if isinstance(image, list) else [image]
        batch = [self.finish([self._open(im) for im in (ims if isinstance(ims, list) else [ims])])
                 for ims in samples]
        return self.get_collate_fn()(batch)

    def open_raw_image(self, index: int) -> np.ndarray:
        """A sample's first image, unnormalized: the smaller edge resized to
        the crop, then the centre (crop, crop) square, uint8 (what the
        attention overlays of ``post_processing`` draw on)."""
        arr = open_image(self.images[index][0], self.ext, self.crop)
        h, w = arr.shape[:2]
        top, left = max((h - self.crop) // 2, 0), max((w - self.crop) // 2, 0)
        return arr[top: top + self.crop, left: left + self.crop]

    def get_collate_fn(self):
        if self.device_preproc:
            is_train = isinstance(self.transform, TrainTransformU8)

            def collate_fn(batch):
                # the random crop runs here as a uint8 slice, so the batch
                # crosses to the device at crop² per image; the device half
                # normalizes with zero offsets
                imgs = [np.asarray(s["image"][0]) for s in batch]
                b, r, c = len(imgs), imgs[0].shape[0], self.crop
                span = max(r - c, 0)
                if is_train and span > 0:
                    tops = self.rng.integers(0, span + 1, b).astype(np.int32)
                    lefts = self.rng.integers(0, span + 1, b).astype(np.int32)
                else:
                    tops = lefts = np.zeros(b, np.int32)
                images = np.stack([im[t: t + c, l: l + c] for im, t, l in zip(imgs, tops, lefts)])
                zeros = torch.zeros(b, dtype=torch.int32)
                return {"images_u8": torch.from_numpy(images), "preproc_tops": zeros,
                        "preproc_lefts": zeros.clone()}

            return collate_fn

        def collate_fn(batch):
            return vilmedic_collate(batch, self.multi_image)

        return collate_fn

    def __repr__(self):
        return "ImageDataset\n" + json.dumps({
            "split": self.split, "len": len(self), "root": self.root, "file": self.file,
            "transform": type(self.transform).__name__, "ext": self.ext,
            "multi_image": self.multi_image, "device_preproc": self.device_preproc,
        }, indent=4, default=str)
