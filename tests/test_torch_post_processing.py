"""The port's evaluation post-processing against the JAX package's, on the
CPU.

- ``save_representation``, ``plot_representation`` (multi-label points,
  ``labels_keep``, per-class subsampling, t-SNE) and ``plot_attention``
  (overlays on a dataset's unnormalized images) on the same results: the
  saved ``.npy`` files bitwise equal, the same plot files written, the
  attention alpha maps and raw images bitwise equal;
- ``config/SELFSUP/convirt-mimic.yml`` as published: its ensemblor's
  ``plot_representation`` runs through the port's ensemble CLI after the
  train CLI (widths cut to 32), saving the embeddings the evaluation
  returned;
- (``tests/test_torch_selfsup.py`` holds the Validator's refusal, when it
  is built, of an unknown step and of a step whose packages are missing.)
"""

import os

import numpy as np
import yaml
from PIL import Image
from threadpoolctl import threadpool_limits

from vilmedic_torch.data.image import ImageDataset as TImageDataset
from vilmedic_torch.scorers import post_processing as tpost
from vilmedic_tpu.data.image import ImageDataset as JImageDataset
from vilmedic_tpu.scorers import post_processing as jpost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _LabelsMap:
    idx2label = {0: "Atelectasis", 1: "Cardiomegaly", 2: "Pneumonia"}
    multi_label = True

    def __len__(self):
        return 3


class _LabelDataset:
    def __init__(self, labels):
        self.labels_map = _LabelsMap()
        self.labels = labels


class _Composite:
    def __init__(self, labels, image=None):
        self.label = _LabelDataset(labels)
        self.image = image


class _Loader:
    def __init__(self, dataset):
        self.dataset = dataset


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_steps_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    n = 40
    labels = [np.eye(3, dtype=np.float32)[i % 3] for i in range(n)]
    labels[1] = np.array([1, 1, 0], np.float32)  # two classes: dropped
    labels[2] = np.array([1, 0, 1], np.float32)  # one kept class once labels_keep applies
    results = {"linguistic": rng.standard_normal((n, 6)).astype(np.float32),
               "visual": rng.standard_normal((n, 1, 6)).astype(np.float32),
               "attentions": rng.random((3, 2, 16)).astype(np.float32)}
    paths = []
    (tmp_path / "images").mkdir()
    for i in range(3):
        paths.append(str(tmp_path / "images" / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (30 + i, 26, 3), dtype=np.uint8)).save(paths[-1])
    (tmp_path / "validate.image.tok").write_text("\n".join(paths) + "\n")
    kw = dict(root=str(tmp_path), file="image.tok", split="validate", ext=".png", crop=20)
    steps = [{"save_representation": {"keys": ["linguistic", "missing"]}},
             {"plot_representation": {"keys": ["linguistic", "visual"],
                                      "labels_keep": ["Atelectasis", "Pneumonia"],
                                      "max_samples_per_class": 8}},
             {"plot_attention": {"max_samples": 2}}]
    for pkg, post, image_ds, out in (("jax", jpost, JImageDataset, "j"),
                                     ("port", tpost, TImageDataset, "t")):
        dl = _Loader(_Composite(labels, image_ds(**kw)))
        # t-SNE's OpenMP gradient on one thread: a step of a few points
        # waits at each barrier for every thread, which a busy host stalls
        with threadpool_limits(1):
            post.post_processing(steps, results=dict(results), split="validate", seed=7,
                                 ckpt_dir=str(tmp_path / out), epoch=0, dl=dl)
    want, got = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert got == want
    assert "plot_representation_7_validate/validate_visual_TSNE.png" in got
    assert "plot_attention_7_validate_0/att_1.png" in got
    npys = [f for f in got if f.endswith(".npy")]
    assert len(npys) == 5
    for f in npys:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f))
    for i in range(3):
        np.testing.assert_array_equal(TImageDataset(**kw).open_raw_image(i),
                                      JImageDataset(**kw).open_raw_image(i))
    np.testing.assert_array_equal(tpost._upscale_attention(results["attentions"][0, 1], 20),
                                  jpost._upscale_attention(results["attentions"][0, 1], 20))


def test_convirt_config_as_published(tmp_path, monkeypatch):
    """The train CLI, then the ensemble CLI with the ensemblor's
    ``post_processing`` as the config file writes it."""
    import vilmedic_torch.bin.train as tcli
    from vilmedic_torch.bin.ensemble import main as ensemble_main
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import selfsup

    monkeypatch.chdir(REPO)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    rng = np.random.default_rng(0)
    reports = ["no acute disease .", "heart size is normal .", "small pleural effusion .",
               "lungs are clear .", "mild cardiomegaly .", "no pneumothorax ."] * 2
    paths = []
    for i in range(len(reports)):
        paths.append(str(tmp_path / f"im{i}.jpg"))
        Image.fromarray(rng.integers(0, 255, (72, 72, 3), dtype=np.uint8)).save(paths[-1])
    for split in ("train", "validate"):
        (tmp_path / f"{split}.image.tok").write_text("\n".join(paths))
        (tmp_path / f"{split}.report.tok").write_text("\n".join(reports))
    cfg, _ = load_config("config/SELFSUP/convirt-mimic.yml", [
        f"ckpt_dir={tmp_path / 'ckpt'}", "name=convirt", "seed=5", "model.dtype=float32",
        f"dataset.image.root={tmp_path}", f"dataset.seq.root={tmp_path}",
        "dataset.image.resize=72", "dataset.image.crop=64", "dataset.num_workers=0",
        "dataset.seq.tokenizer=null", "model.encoder.hidden_size=32",
        "model.encoder.num_hidden_layers=1", "model.encoder.num_attention_heads=4",
        "model.encoder.intermediate_size=64", "model.cnn.backbone=resnet18",
        "model.projection.projection_dim=16", "trainor.batch_size=6", "trainor.epochs=0",
        "validator.batch_size=6", "ensemblor.batch_size=6", "ensemblor.splits=[validate]"])
    assert cfg.to_dict()["ensemblor"]["post_processing"][0]["plot_representation"]["keys"] == [
        "linguistic", "visual"]
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    tcli.main([str(path), "device=cpu"])
    kept = []
    real = selfsup.convirt_evaluation

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        kept.append({k: np.array(v) for k, v in out.items() if k in ("linguistic", "visual")})
        return out

    monkeypatch.setattr(selfsup, "convirt_evaluation", recorded)
    with threadpool_limits(1):  # t-SNE's OpenMP, as above
        ensemble_main([str(path), "device=cpu"])
    out = tmp_path / "ckpt" / "convirt" / "plot_representation_5_validate"
    for key in ("linguistic", "visual"):
        assert (out / f"validate_{key}_TSNE.png").exists()
        np.testing.assert_array_equal(np.load(out / f"validate_{key}_embeddings.npy"),
                                      kept[-1][key].reshape(len(reports), -1))
        assert set(np.load(out / f"validate_{key}_labels.npy")) == {"all"}
