"""The port's data layer against the JAX package's, on the CPU.

- the WordPiece tokenizer against ``transformers.BertTokenizer(vocab_file,
  do_basic_tokenize=False)``, on an r2gen-cleaned corpus's vocabulary and on
  a vocabulary with ``##`` pieces: ids, masks, truncation, padding and
  decoding exactly equal;
- the report cleaners against the JAX package's: equal strings;
- ``ImSeq`` batches against the JAX package's on JPEG fixtures (written as
  in ``tests/test_train_e2e.py``): ids and masks exactly equal, float
  images within 1e-6 (the same f32 operations; NHWC in JAX, NCHW here), the
  uint8 batches of ``device_preproc`` bitwise equal, and the built
  vocabulary files equal; the train split's random crops and flips equal
  too once JAX's transform draws from a generator of the same seed;
- the ``DataLoader``'s batch order against the JAX loader's over three
  epochs, and its threads drawing the crops and flips of one thread;
- the train CLI with no ``seed:`` in its config: the loader follows the
  run's seed (different seeds, different first batches; equal seeds, equal
  ones).
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from transformers import BertTokenizer

from vilmedic_torch.data import composites as tcomposites  # noqa: F401  (registers ImSeq)
from vilmedic_torch.data import processing as tprocessing
from vilmedic_torch.data.image import finalize_device_preproc
from vilmedic_torch.data.loader import DataLoader as TDataLoader
from vilmedic_torch.data.tokenizer import WordPieceTokenizer
from vilmedic_torch.data.utils import Vocab
from vilmedic_tpu.data import processing as jprocessing
from vilmedic_tpu.data.composites import ImSeq as JImSeq
from vilmedic_tpu.data.loader import DataLoader as JDataLoader

RAW_REPORTS = [
    "1. No acute cardiopulmonary process. 2. Stable cardiomegaly.",
    "Heart size is normal; lungs are clear: no effusion/pneumothorax.",
    "FINDINGS:  Small  left pleural effusion... Mild bibasilar atelectasis (likely).",
    "There is a 3.5 cm nodule in the right upper lobe [see prior] -- recommend CT.",
    "Interval improvement of \"edema\"; NG tube tip in the stomach__ unchanged.",
    "",
    "Lines and tubes: ET tube 4 cm above the carina. 3. No pneumothorax.",
    "Compared to prior, opacities @ right base are <= before, 50% smaller!",
]
VALIDATE_REPORTS = [
    "no acute cardiopulmonary process . unseen words here .",
    "heart size is NORMAL and the lungs are clear .",
    "small left pleural effusion with " + " ".join(["atelectasis"] * 30) + " .",
    "[SEP] mild bibasilar atelectasis[PAD]likely",
]
MAX_LEN = 16


def _processed(reports):
    clean = tprocessing.r2gen_clean_report
    return [clean(r.strip()).split() for r in reports]


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    corpus = root / "vocab.tgt"
    Vocab(_processed(RAW_REPORTS)).dump(str(corpus))
    pieces = root / "vocab.pieces"
    pieces.write_text("\n".join(["[CLS]", "[PAD]", "[SEP]", "[UNK]", "[MASK]", "ab", "##ab",
                                 "##c", "heart", "##s", "size", ".", "lung", "##x##"]))
    return {"corpus": str(corpus), "pieces": str(pieces)}


TEXTS = {
    "corpus": [" ".join(s) for s in _processed(RAW_REPORTS)] + VALIDATE_REPORTS,
    "pieces": ["abab abc hearts size .", "lungs heart ab##ab abd", "lung##x## [UNK] x" * 3,
               "Heart ab" + "c" * 120],
}


@pytest.mark.parametrize("vocab", ["corpus", "pieces"])
def test_tokenizer_matches_bert_tokenizer(vocab_files, vocab):
    """Tokens, ids, truncation, padding to max_length and to the longest
    row (with and without special tokens), and decoding, exactly as
    transformers' BertTokenizer without basic tokenization."""
    ref = BertTokenizer(vocab_file=vocab_files[vocab], do_basic_tokenize=False)
    ours = WordPieceTokenizer(vocab_files[vocab])
    texts = TEXTS[vocab]
    assert ours.vocab_size == ref.vocab_size
    assert (ours.cls_token_id, ours.sep_token_id, ours.pad_token_id) == (
        ref.cls_token_id, ref.sep_token_id, ref.pad_token_id)
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text), text
    for kwargs, max_length in ((dict(padding="max_length", truncation=True,
                                     max_length=MAX_LEN), MAX_LEN), (dict(padding=True), None)):
        for special in (True, False):
            want = ref(texts, return_tensors="np", add_special_tokens=special, **kwargs)
            ids, mask = ours.encode_batch(texts, max_length=max_length,
                                          add_special_tokens=special)
            np.testing.assert_array_equal(ids, want["input_ids"])
            np.testing.assert_array_equal(mask, want["attention_mask"])
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, ours.vocab_size + 3, 20) for _ in range(20)] + list(ids)
    for row in rows:
        for skip in (True, False):
            assert ours.decode(row, skip_special_tokens=skip) == ref.decode(
                row, skip_special_tokens=skip, clean_up_tokenization_spaces=False)


@pytest.mark.parametrize("name", ["r2gen_clean_report", "ifcc_clean_report",
                                  "gloria_clean_report_chexpert", "rouge", "identity"])
def test_processing_matches_jax(name):
    ours, theirs = tprocessing.get_processing(name), jprocessing.get_processing(name)
    for report in RAW_REPORTS + VALIDATE_REPORTS:
        assert ours(report) == theirs(report), report


def test_ifcc_clean_report_needs_no_nltk(monkeypatch):
    """The RRS cleaner runs where NLTK is not installed (the card's
    machine) and still splits as NLTK's ``wordpunct_tokenize``: runs of
    punctuation stay together, ``_`` and digits are word characters."""
    hard = ["Hx: s/p CABG... R-sided PICC (tip @ SVC)!!", "No e\u0301 change __x__ 3.5cm;;",
            "ET tube 4.2 cm above carina.\nNG-tube,\tin stomach?", ""]
    want = [jprocessing.get_processing("ifcc_clean_report")(r) for r in hard]
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setitem(sys.modules, "nltk.tokenize", None)
    assert [tprocessing.ifcc_clean_report(r) for r in hard] == want


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """JPEGs of several sizes (one grey), as ``tests/test_train_e2e.py``
    writes them, and line files for both splits."""
    root = tmp_path_factory.mktemp("imseq")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(RAW_REPORTS)):
        shape = [(48, 48, 3), (60, 44, 3), (40, 52, 3), (48, 48)][i % 4]
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.report.tok").write_text("\n".join(RAW_REPORTS))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
    return root


def _imseq_config(root, device_preproc):
    return dict(
        seq={"root": str(root), "file": "report.tok", "source": "tgt", "tokenizer_max_len": 12,
             "processing": "r2gen_clean_report", "tokenizer": None},
        image={"root": str(root), "file": "image.tok", "resize": 40, "crop": 32, "ext": ".jpg",
               "device_preproc": device_preproc},
    )


def _both_datasets(root, tmp_path, split, device_preproc):
    cfg = _imseq_config(root, device_preproc)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(parents=True, exist_ok=True)
    tdir.mkdir(parents=True, exist_ok=True)
    if split != "train":  # the vocabulary comes from the train split
        JImSeq(**cfg, split="train", ckpt_dir=str(jdir))
        tcomposites.ImSeq(**cfg, split="train", ckpt_dir=str(tdir))
    jds = JImSeq(**cfg, split=split, ckpt_dir=str(jdir))
    tds = tcomposites.ImSeq(**cfg, split=split, ckpt_dir=str(tdir), seed=0)
    assert (jdir / "vocab.tgt").read_text() == (tdir / "vocab.tgt").read_text()
    return jds, tds


def _collate(ds, indices):
    return ds.get_collate_fn()([ds[i] for i in indices])


@pytest.mark.parametrize("split", ["train", "validate"])
def test_imseq_float_batches_match_jax(image_root, tmp_path, split):
    """Host float images (train: random crops and flips from generators of
    one seed on both sides) within 1e-6, ids and masks exactly equal."""
    jds, tds = _both_datasets(image_root, tmp_path, split, device_preproc=False)
    if split == "train":
        jds.image.transform.rng = np.random.default_rng(0)
    for indices in ([0, 1, 2, 3], [7, 4, 5, 6]):
        want, got = _collate(jds, indices), _collate(tds, indices)
        np.testing.assert_array_equal(got["input_ids"].numpy(), want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"].numpy(), want["attention_mask"])
        assert got["images"].shape == (4, 3, 32, 32) and got["images"].dtype == torch.float32
        np.testing.assert_allclose(got["images"].permute(0, 2, 3, 1).numpy(), want["images"],
                                   rtol=0, atol=1e-6)


def test_imseq_device_preproc_batches_match_jax(image_root, tmp_path):
    """Eval uint8 batches bitwise JAX's, zero offsets, and the device half
    normalizes them into the float path's images (within 1e-6)."""
    jds, tds = _both_datasets(image_root, tmp_path, "validate", device_preproc=True)
    want, got = _collate(jds, range(4)), _collate(tds, range(4))
    assert got["images_u8"].dtype == torch.uint8 and got["images_u8"].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got["images_u8"].numpy(), want["images_u8"])
    assert not got["preproc_tops"].any() and not got["preproc_lefts"].any()
    images = finalize_device_preproc(got, 32)["images"]
    _, tfloat = _both_datasets(image_root, tmp_path / "f", "validate", device_preproc=False)
    np.testing.assert_allclose(images.numpy(), _collate(tfloat, range(4))["images"].numpy(),
                               rtol=0, atol=1e-6)


def test_imseq_train_device_preproc_is_seeded(image_root, tmp_path):
    """Train uint8 batches: host-cropped to (crop, crop), and the same
    batches for the same seed."""
    cfg = _imseq_config(image_root, True)
    batches = [_collate(tcomposites.ImSeq(**cfg, split="train", ckpt_dir=str(tmp_path), seed=3),
                        range(8)) for _ in range(2)]
    assert batches[0]["images_u8"].shape == (8, 32, 32, 3)
    assert torch.equal(batches[0]["images_u8"], batches[1]["images_u8"])


@pytest.mark.parametrize("device_preproc", [False, True])
def test_threaded_loader_draws_as_one_worker(image_root, tmp_path, device_preproc):
    """Train batches (random crops and flips from one seed) through two
    loader threads equal those of ``num_workers=0``, exactly, over two
    shuffled epochs."""
    cfg = _imseq_config(image_root, device_preproc)
    runs = []
    for workers in (0, 2):
        ds = tcomposites.ImSeq(**cfg, split="train", ckpt_dir=str(tmp_path), seed=5)
        dl = TDataLoader(ds, batch_size=2, shuffle=True, num_workers=workers, seed=5, prefetch=3)
        batches = []
        for epoch in range(2):
            dl.set_epoch(epoch)
            batches += list(dl)
        runs.append(batches)
    assert len(runs[0]) == len(runs[1]) == 8
    for one, two in zip(*runs):
        assert one.keys() == two.keys()
        for key in one:
            assert torch.equal(one[key], two[key]), key


def test_dataloader_batch_order_matches_jax():
    """Shuffled train batches (drop_last) and ordered eval batches equal the
    JAX loader's indices for three epochs."""

    class Items:
        def __len__(self):
            return 37

        def __getitem__(self, i):
            return i

        def get_collate_fn(self):
            return lambda items: list(items)

    for shuffle in (True, False):
        kwargs = dict(batch_size=8, shuffle=shuffle, drop_last=shuffle, num_workers=2, seed=11)
        ours, theirs = TDataLoader(Items(), **kwargs), JDataLoader(Items(), **kwargs)
        assert len(ours) == len(theirs)
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)


def test_dataloader_reraises_a_failed_load():
    class Broken:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 9:
                raise OSError("unreadable image")
            return i

        def get_collate_fn(self):
            return list

    with pytest.raises(OSError, match="unreadable"):
        list(TDataLoader(Broken(), batch_size=4, num_workers=2))


def test_pretrained_tokenizer_name_raises(tmp_path, monkeypatch):
    """A pretrained tokenizer that is not on disk raises, naming it and the
    paths tried (the port never reaches the network), and writes nothing."""
    from vilmedic_torch.data.text import TextDataset

    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    with pytest.raises(FileNotFoundError, match="allenai/biomed_roberta_base.*tried"):
        TextDataset(root=str(tmp_path), split="train", ckpt_dir=str(tmp_path), source="tgt",
                    tokenizer_max_len=8, tokenizer="allenai/biomed_roberta_base")
    assert not os.listdir(tmp_path)


def _first_train_batch(image_root, tmp_path, run_seed, monkeypatch):
    """The first batch the train CLI trains on, when the config sets no
    ``seed:`` and the run draws ``run_seed`` (``bin/train.py`` draws it with
    ``utils.seed.get_seed``)."""
    import vilmedic_torch.blocks.vision.densenet as tdensenet
    import vilmedic_torch.utils.seed as tseed
    from vilmedic_torch.bin.train import main
    from vilmedic_torch.executors.trainor import Trainor

    monkeypatch.setattr(tseed, "randrange", lambda low, high: run_seed)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    seen = []
    real = Trainor._model_batch

    def record(self, batch):
        if not seen:
            seen.append({k: v.clone() for k, v in batch.items() if torch.is_tensor(v)})
        return real(self, batch)

    monkeypatch.setattr(Trainor, "_model_batch", record)
    trainor = main([
        "config/RRG/baseline-mimic.yml", f"ckpt_dir={tmp_path}", "name=seeded", "device=cpu",
        "model.dtype=float32", f"dataset.image.root={image_root}", "dataset.image.file=image.tok",
        "dataset.image.resize=40", "dataset.image.crop=32", f"dataset.seq.root={image_root}",
        "dataset.seq.file=report.tok", "dataset.seq.tokenizer_max_len=12",
        "dataset.num_workers=0", "model.cnn.backbone=densenet_tiny",
        "model.cnn.visual_projection.in_features=32", "model.cnn.visual_projection.out_features=32",
        "model.decoder.hidden_size=32", "model.decoder.num_attention_heads=4",
        "model.decoder.intermediate_size=64", "model.decoder.max_position_embeddings=64",
        "trainor.batch_size=4", "trainor.epochs=0", "trainor.eval_start=10",
        "trainor.early_stop_metric=training_loss", "validator.metrics=[]",
    ])
    assert trainor.seed == run_seed and trainor.dl.seed == run_seed
    return seen[0]


def test_cli_loader_follows_the_run_seed(image_root, tmp_path, monkeypatch):
    """With no ``seed:`` in the config the loader's shuffle and train crops
    come from the run's seed: two runs with different seeds draw different
    first batches, two with the same seed equal ones."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    a = _first_train_batch(image_root, tmp_path / "a", 111111, monkeypatch)
    b = _first_train_batch(image_root, tmp_path / "b", 111111, monkeypatch)
    c = _first_train_batch(image_root, tmp_path / "c", 222222, monkeypatch)
    assert sorted(a) == sorted(b) == sorted(c) and "images" in a
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["images"], c["images"])
