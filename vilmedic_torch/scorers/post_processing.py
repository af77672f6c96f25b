"""Evaluation post-processing (port of ``scorers/post_processing.py``): a
config list such as ``post_processing: [{plot_representation: {keys:
[...], labels_keep: [...], max_samples_per_class: 250}}]``, dispatched by
name after a split's scores, writing into ``ckpt_dir``:

- ``save_representation``: the results' embedding matrices as ``.npy``;
- ``plot_representation``: embeddings coloured by the dataset's labels (a
  multi-label point is kept only when exactly one kept class is active),
  ``labels_keep`` filtering, the embeddings and labels saved as ``.npy``,
  per-class subsampling (``max_samples_per_class``, drawn from a generator
  seeded with the run's seed), then one scatter per projector: scikit-learn's
  t-SNE, and UMAP where ``umap`` imports;
- ``plot_attention``: attention rows upscaled (PIL bicubic and a Gaussian
  blur) over the dataset's unnormalized images
  (``ImageDataset.open_raw_image``), Reds colormap and colorbar.

scikit-learn, matplotlib, umap and Pillow are imported inside the plot
functions only. :func:`check_post_processing` runs when the Validator is
built, before any training: an unknown step, or a step whose packages do
not import, raises there rather than after the run.
"""

from __future__ import annotations

import importlib.util
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

# the packages each step imports
NEEDS = {
    "save_representation": (),
    "plot_representation": (("sklearn", "scikit-learn"), ("matplotlib", "matplotlib")),
    "plot_attention": (("matplotlib", "matplotlib"), ("PIL", "Pillow")),
}


def _steps(post_processing):
    """``(name, arguments)`` of each entry: a step name, or a one-key dict
    of its arguments."""
    if hasattr(post_processing, "to_dict"):
        post_processing = post_processing.to_dict()
    for entry in post_processing or []:
        if isinstance(entry, str):
            yield entry, {}
        else:
            name = next(iter(entry))
            args = entry[name] or {}
            yield name, args.to_dict() if hasattr(args, "to_dict") else dict(args)


def check_post_processing(post_processing) -> None:
    """Raise ``ValueError`` for an unknown step and ``ImportError`` for a
    step whose packages are not installed."""
    for name, _ in _steps(post_processing):
        if name not in NEEDS:
            raise ValueError(f"Unknown post-processing step {name!r}; known: {sorted(NEEDS)}")
        missing = [label for module, label in NEEDS[name]
                   if importlib.util.find_spec(module) is None]
        if missing:
            raise ImportError(f"post_processing {name!r} needs {' and '.join(missing)}, "
                              "which is not installed")


def _find_label_dataset(dataset):
    """The composite's label dataset (the child with a ``labels_map``)."""
    if hasattr(dataset, "labels_map"):
        return dataset
    for v in vars(dataset).values():
        if hasattr(v, "labels_map") and getattr(v, "labels_map") is not None:
            return v
    return None


def save_representation(results, keys=None, key=None, split=None, seed=None,
                        ckpt_dir=None, epoch=None, dl=None, **kwargs):
    """Save ``results[key]`` for each key as ``{split}_{key}_embeddings.npy``."""
    out_dir = os.path.join(ckpt_dir, f"save_representation_{seed}_{split}")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k in keys or ([key] if key else []):
        if k not in results:
            logger.warning(f"Key {k} is not found in results dictionary")
            continue
        arr = np.asarray(results[k])
        path = os.path.join(out_dir, f"{split}_{k}_embeddings.npy")
        np.save(path, arr)
        paths.append(path)
    return paths


def _filter_by_labels(vectors, labels, labels_map, multi_label, labels_keep):
    """Each point's label, and the ``labels_keep`` filter."""
    embeddings, emb_labels = [], []
    for vector, label in zip(vectors, labels):
        if multi_label:
            c = np.where(np.asarray(label) == 1.0)[0]
            if labels_keep is not None:
                c = [c_ for c_ in c if labels_map[int(c_)] in labels_keep]
            if len(c) != 1:
                continue  # ambiguous point: more than one (kept) class, or none
            label = int(c[0])
        else:
            label = int(label)
            if labels_keep is not None and labels_map[label] not in labels_keep:
                continue
        emb_labels.append(labels_map[label])
        embeddings.append(np.asarray(vector))
    return np.array(embeddings), np.array(emb_labels)


def _subsample_per_class(embeddings, emb_labels, max_samples_per_class, rng):
    """At most ``max_samples_per_class`` points of each class, drawn by
    ``rng``."""
    if not isinstance(max_samples_per_class, int):
        logger.warning(
            f"Argument max_samples_per_class is not an integer, found "
            f"{type(max_samples_per_class)}. Using all points"
        )
        return embeddings, emb_labels
    new_e, new_l = [], []
    for g in np.unique(emb_labels):
        ix = np.where(emb_labels == g)[0]
        rng.shuffle(ix)
        new_l.append(emb_labels[ix[:max_samples_per_class]])
        new_e.append(embeddings[ix[:max_samples_per_class]])
    return np.concatenate(new_e), np.concatenate(new_l)


def _projectors(n_points: int, n_classes: int):
    from sklearn.manifold import TSNE

    yield TSNE(n_components=2, init="pca",
               perplexity=min(30, max(2, n_points // 4)))
    try:
        import umap

        yield umap.UMAP(n_neighbors=max(2, n_classes))
    except ImportError:
        logger.info("umap-learn not installed; skipping the UMAP projection")


def plot_representation(results, keys, split, seed, ckpt_dir, epoch, dl,
                        labels_keep=None, max_samples_per_class=None, **kwargs):
    """Label-coloured embedding scatters, one per projector; returns the
    plot files."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    label_dataset = _find_label_dataset(dl.dataset)
    out_dir = os.path.join(ckpt_dir, f"plot_representation_{seed}_{split}")
    os.makedirs(out_dir, exist_ok=True)
    written = []

    for key in keys:
        if key not in results:
            logger.warning(f"Key {key} is not found in results dictionary")
            continue
        vectors = [np.asarray(v).reshape(-1) for v in results[key]]

        if label_dataset is not None:
            labels = label_dataset.labels
            labels_map = label_dataset.labels_map.idx2label
            multi_label = label_dataset.labels_map.multi_label
            embeddings, emb_labels = _filter_by_labels(
                vectors, labels, labels_map, multi_label, labels_keep
            )
            n_classes = len(labels_map)
        else:  # no labels available: single unnamed class
            embeddings = np.array(vectors)
            emb_labels = np.array(["all"] * len(embeddings))
            n_classes = 1

        np.save(os.path.join(out_dir, f"{split}_{key}_embeddings.npy"), embeddings)
        np.save(os.path.join(out_dir, f"{split}_{key}_labels.npy"), emb_labels)
        assert len(embeddings) != 0, "No embedding kept for visualization"

        if max_samples_per_class is not None:
            embeddings, emb_labels = _subsample_per_class(
                embeddings, emb_labels, max_samples_per_class,
                np.random.default_rng(int(seed or 0)))

        for visualization in _projectors(len(embeddings), n_classes):
            name = type(visualization).__name__
            proj = visualization.fit_transform(embeddings)
            fig = plt.figure()
            for g in np.unique(emb_labels):
                ix = np.where(emb_labels == g)
                plt.scatter(proj[ix, 0], proj[ix, 1], s=0.5, label=g)
            plt.legend(markerscale=10, loc="center left", bbox_to_anchor=(1, 0.5))
            plt.tight_layout()
            path = os.path.join(out_dir, f"{split}_{key}_{name}.png")
            fig.savefig(path, dpi=120)
            plt.close(fig)
            written.append(path)
    return written


def _upscale_attention(weights: np.ndarray, size: int, smooth: bool = True):
    """(S,) or (s, s) attention -> (size, size) alpha map: PIL bicubic
    resize and a Gaussian blur."""
    from PIL import Image, ImageFilter

    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        square = int(np.sqrt(len(w)))
        w = w[: square * square].reshape(square, square)
    w = w - w.min()
    if w.max() > 0:
        w = w / w.max()
    im = Image.fromarray((w * 255).astype(np.uint8))
    im = im.resize((size, size), Image.BICUBIC)
    if smooth:
        im = im.filter(ImageFilter.GaussianBlur(radius=size / 16))
    return np.asarray(im, np.float64) / 255.0


def plot_attention(results, split, seed, ckpt_dir, epoch, dl, smooth=True,
                   max_samples: int = 8, **kwargs):
    """Attention overlays on the input images, from ``results['attentions']``
    shaped (N, ..., S): the trailing axis is the patch attention row, and
    the axes between the sample axis and it (layers, heads, queries) take
    their last slice."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    attentions = results.get("attentions")
    if attentions is None:
        logger.warning("No attention weights found in results, skipping")
        return []
    att = np.asarray(attentions)
    out_dir = os.path.join(ckpt_dir, f"plot_attention_{seed}_{split}_{epoch}")
    os.makedirs(out_dir, exist_ok=True)

    dataset = dl.dataset
    image_dataset = dataset if hasattr(dataset, "open_raw_image") else None
    if image_dataset is None:
        for v in vars(dataset).values():
            if hasattr(v, "open_raw_image"):
                image_dataset = v
                break

    written = []
    for i in range(min(max_samples, att.shape[0])):
        weights = att[i]
        while weights.ndim > 1:
            weights = weights[-1]  # last layer/head/query row

        if image_dataset is not None:
            img = image_dataset.open_raw_image(i)
            img = np.asarray(img, np.float64)
            if img.max() > 1:
                img = img / 255.0
            size = img.shape[0]
        else:
            img = None
            size = 224

        alpha = _upscale_attention(weights, size, smooth=smooth)
        fig, ax = plt.subplots()
        if img is not None:
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        m = ax.imshow(alpha, alpha=0.6, cmap=cm.Reds)
        fig.colorbar(m, ax=ax)
        ax.axis("off")
        path = os.path.join(out_dir, f"att_{i}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


_DISPATCH = {
    "save_representation": save_representation,
    "plot_representation": plot_representation,
    "plot_attention": plot_attention,
}


def post_processing(post_processing, results, split, seed, ckpt_dir, epoch, dl):
    """Run each step of a ``post_processing`` list on a split's results."""
    for name, args in _steps(post_processing):
        _DISPATCH[name](results=results, split=split, seed=seed, ckpt_dir=ckpt_dir,
                        epoch=epoch, dl=dl, **args)
