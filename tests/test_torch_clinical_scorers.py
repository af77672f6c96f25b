"""The port's clinical scorers (CheXbert, RadNER, RadGraph, the BERTNLI pair
classifier, RadEntityMatchExact, RadEntityNLI, StanfordCTAbdAcc) against
the JAX package's, on the CPU.

Both packages read the same files, laid out as ``VILMEDIC_WEIGHTS_DIR``
expects and written here by ``transformers`` with random weights from a
seed, as ``tests/test_chexbert.py`` and ``tests/test_clinical_scorers.py``
make theirs: a CheXbert ``chexbert.pth`` (``module.``-prefixed inside
``model_state_dict``, as shipped), a RadNER ``BertForTokenClassification``
directory with RadGraph's labels, a BERTNLI ``.pth`` and a BERTScore BERT
directory; 2-layer BERTs of hidden 128 (2 heads of 64), over a vocabulary
of ~200 words. The encoders' weight matrices are drawn wider than BERT's
init (std 0.1) and the heads' with std 0.5, so that labels differ between
reports and the top-two logit gaps lie far above the logits' tolerance:
equal labels are a real check.

Held against the JAX package: CheXbert logits (1e-5 abs + rel) and class
ids (equal), the ``F1CheXbert`` tuple, RadNER entities (equal), RadGraph
rewards (exact), NLI labels (equal), RadEntityMatchExact and RadEntityNLI
(1e-6), ``compute_scores`` over the clinical keys (1e-6; ``None`` without
weights), and the SCST rewards (equal); the multilabel report against
scikit-learn (1e-12); and the RoBERTa RRG config's eight Validator metrics
through both train CLIs.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vilmedic_torch.scorers import chexbert as tchexbert
from vilmedic_torch.scorers import clinical as tclinical
from vilmedic_torch.scorers import nli as tnli
from vilmedic_torch.scorers import radgraph as tradgraph
from vilmedic_torch.scorers.classification import multilabel_report
from vilmedic_torch.scorers.ner import RadNER as TRadNER
from vilmedic_torch.scorers.scores import compute_scores as tcompute
from vilmedic_tpu.scorers import chexbert as jchexbert
from vilmedic_tpu.scorers import clinical as jclinical
from vilmedic_tpu.scorers import nli as jnli
from vilmedic_tpu.scorers import radgraph as jradgraph
from vilmedic_tpu.scorers.ner import RadNER as JRadNER
from vilmedic_tpu.scorers.scores import compute_scores as jcompute

REPO = Path(__file__).resolve().parents[1]
HIDDEN, LAYERS, HEADS, INTER, MAXPOS = 128, 2, 2, 256, 512
TOL_LOGITS, TOL_SCORE = 1e-5, 1e-6
BODY_STD, HEAD_STD = 0.1, 0.5  # encoder and head weights (module doc)
NER_LABELS = ["O", "ANAT-DP", "OBS-DP", "OBS-U", "OBS-DA"]
WORDS = ("no acute cardiopulmonary process heart size is normal mild cardiomegaly "
         "the lungs are clear small left right pleural effusion effusions edema pulmonary "
         "vascular congestion consolidation atelectasis at base bases lung lobe upper lower "
         "opacity opacities pneumothorax there no evidence of pneumonia stable mediastinal "
         "contours unchanged compared to prior study with moderate large bilateral bibasilar "
         "suggestive concerning for infection likely represents subsegmental interval "
         "increase decrease in tube line catheter tip terminates svc pacemaker leads "
         "fracture rib osseous structures intact hilar enlarged silhouette within limits "
         "chest radiograph frontal lateral view views obtained degenerative changes spine "
         "thoracic aorta tortuous calcified granuloma nodule mass lesion trace blunting "
         "costophrenic angle hemidiaphragm elevated free air under diaphragm").split()
SUFFIXES = ["##s", "##ed", "##ing", "##ly", "##al", "##ity"]
VOCAB = (["[PAD]"] + [f"[unused{i}]" for i in range(4)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + sorted(set(WORDS)) + SUFFIXES + list(".,;:-()/") + [str(d) for d in range(10)])
METRIC_KEYS = ["chexbert-5_micro avg_f1-score", "chexbert-all_micro avg_f1-score",
               "chexbert-5_macro avg_f1-score", "chexbert-all_macro avg_f1-score",
               "radgraph_simple", "radgraph_partial", "radgraph_complete",
               "radentitymatchexact", "radentitynli"]
CLINICAL = ["chexbert", "radgraph", "radentitymatchexact", "radentitynli",
            "stanford_ct_abd_accuracy"]


def _reports(n, seed):
    """``n`` reports of 1-3 sentences over the vocabulary, a few words
    outside it (``[UNK]``), some with word pieces and CT-abdomen phrases."""
    rng = np.random.default_rng(seed)
    extra = ["Hydronephrosis", "splenomegaly", "ascites", "opacitys", "zzq", "Effusions,"]
    out = []
    for _ in range(n):
        sentences = []
        for _ in range(rng.integers(1, 4)):
            words = list(rng.choice(WORDS + extra, size=rng.integers(3, 9)))
            sentences.append(" ".join(words) + " .")
        out.append(" ".join(sentences))
    return out


REFS, HYPS = _reports(12, 1), _reports(12, 2)
HYPS[3] = REFS[3]  # one exact match
HYPS[5] = ""  # an empty hypothesis: no sentence


def _widen(module, std, gen):
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, std, generator=gen)


def _bert_config(**kw):
    from transformers import BertConfig

    return BertConfig(vocab_size=len(VOCAB), hidden_size=HIDDEN, num_hidden_layers=LAYERS,
                      num_attention_heads=HEADS, intermediate_size=INTER,
                      max_position_embeddings=MAXPOS, **kw)


def write_scorer_weights(root: Path) -> Path:
    """The scorer files of the module doc under ``root``, in the layout of
    ``VILMEDIC_WEIGHTS_DIR``."""
    from transformers import BertForTokenClassification, BertModel, BertTokenizer

    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    for sub in ("chexbert", "radnli", "radner", "bertscore/model"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    vocab = "\n".join(VOCAB)
    for sub in ("chexbert", "radnli"):
        (root / sub / "vocab.txt").write_text(vocab)

    bert = BertModel(_bert_config())
    _widen(bert, BODY_STD, gen)
    heads = torch.nn.ModuleList(torch.nn.Linear(HIDDEN, n) for n in jchexbert.HEAD_CLASSES)
    _widen(heads, HEAD_STD, gen)
    state = {**{f"module.bert.{k}": v for k, v in bert.state_dict().items()},
             **{f"module.linear_heads.{k}": v for k, v in heads.state_dict().items()}}
    torch.save({"model_state_dict": state, "epoch": 3}, root / "chexbert" / "chexbert.pth")

    bert = BertModel(_bert_config())
    _widen(bert, BODY_STD, gen)
    linear = torch.nn.Linear(HIDDEN, 3)
    _widen(linear, HEAD_STD, gen)
    state = {**{f"bert.{k}": v for k, v in bert.state_dict().items()},
             **{f"linear.{k}": v for k, v in linear.state_dict().items()}}
    torch.save(state, root / "radnli" / "model_medrad_19k.pth")

    ner = BertForTokenClassification(_bert_config(
        num_labels=len(NER_LABELS), id2label=dict(enumerate(NER_LABELS)),
        label2id={x: i for i, x in enumerate(NER_LABELS)}))
    _widen(ner.bert, BODY_STD, gen)
    _widen(ner.classifier, HEAD_STD, gen)
    ner.save_pretrained(root / "radner")
    (root / "radner" / "vocab.txt").write_text(vocab)
    BertTokenizer(vocab_file=str(root / "radner" / "vocab.txt")).save_pretrained(root / "radner")

    model_dir = root / "bertscore" / "model"
    BertModel(_bert_config()).save_pretrained(model_dir)
    (model_dir / "vocab.txt").write_text(vocab)
    BertTokenizer(vocab_file=str(model_dir / "vocab.txt")).save_pretrained(model_dir)
    return root


SCORER_ENV = ("CHEXBERT_PTH", "CHEXBERT_VOCAB", "RADNLI_PTH", "RADNLI_VOCAB", "RADNER_MODEL",
              "BERTSCORE_MODEL", "BERTSCORE_BASELINE", "BERTSCORE_BASELINE_TSV",
              "VILMEDIC_TPU_CACHE")


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    return write_scorer_weights(tmp_path_factory.mktemp("scorer_weights"))


@pytest.fixture
def scorer_env(weights_dir, monkeypatch, tmp_path):
    for key in SCORER_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VILMEDIC_WEIGHTS_DIR", str(weights_dir))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    return weights_dir


@pytest.fixture(scope="module")
def labelers(weights_dir):
    with pytest.MonkeyPatch.context() as mp:
        for key in SCORER_ENV:
            mp.delenv(key, raising=False)
        mp.setenv("VILMEDIC_WEIGHTS_DIR", str(weights_dir))
        return dict(j=jchexbert.CheXbert(), t=tchexbert.CheXbert(device="cpu"),
                    jner=JRadNER(), tner=TRadNER(device="cpu"),
                    jnli=jnli.NLIPredictor(), tnli=tnli.NLIPredictor(device="cpu"))


# ---------------------------------------------------------------- CheXbert


def test_chexbert_logits_and_classes_match_jax(labelers):
    import jax.numpy as jnp

    j, t = labelers["j"], labelers["t"]
    texts = REFS + HYPS
    rows = [t.tokenizer.encode_truncated(r.strip(), max_length=512) for r in texts]
    assert rows == [j.tokenizer.encode(r.strip(), max_length=512, truncation=True)
                    for r in texts]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int64)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    want = j.module.apply({"params": j.params}, jnp.asarray(ids, jnp.int32),
                          jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        got = t.module(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(got) == len(want) == 14
    gaps = []
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_LOGITS, atol=TOL_LOGITS)
        top2 = np.sort(np.asarray(w), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
    assert np.min(gaps) > 100 * TOL_LOGITS  # labels far from a tie
    want_classes = j.predict_classes(texts)
    got_classes = t.predict_classes(texts)
    np.testing.assert_array_equal(got_classes, want_classes)
    assert len({tuple(r) for r in got_classes}) > 6  # the labels differ between reports
    for mode in ("rrg", "classification"):
        assert t.get_labels(texts, mode=mode) == j.get_labels(texts, mode=mode)


def test_f1chexbert_matches_jax(labelers, tmp_path):
    want = jchexbert.F1CheXbertImpl(labeler=labelers["j"])(HYPS, REFS)
    refs_file, hyps_file = tmp_path / "refs.chexbert.txt", tmp_path / "hyps.chexbert.txt"
    metric = tclinical.F1CheXbert(refs_filename=str(refs_file), hyps_filename=str(hyps_file),
                                  labeler=labelers["t"])
    for got in (metric(HYPS, REFS), metric(HYPS, REFS)):  # the second reads the refs' cache
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            assert list(g) == list(w)
            for key in w:
                for h in w[key]:
                    assert abs(g[key][h] - w[key][h]) <= 1e-12, (key, h)
    assert refs_file.read_text().split("\n") == list(map(str, labelers["t"].get_labels(REFS)))
    assert hyps_file.exists()


@pytest.mark.parametrize("case", range(6))
def test_multilabel_report_matches_sklearn(case):
    from sklearn.metrics import classification_report

    rng = np.random.default_rng(case)
    n, labels = int(rng.integers(1, 16)), int(rng.integers(2, 15))
    refs = (rng.uniform(size=(n, labels)) < rng.uniform(0.05, 0.6)).astype(int)
    preds = (rng.uniform(size=(n, labels)) < rng.uniform(0.05, 0.6)).astype(int)
    if case == 4:
        refs[:] = 0  # every support 0: the weighted average falls back to unweighted
    if case == 5:
        preds[:] = 0  # nothing predicted: zero_division=0 everywhere
    names = [f"c{i}" for i in range(labels)]
    want = classification_report(refs, preds, target_names=names, output_dict=True,
                                 zero_division=0)
    got = multilabel_report(refs, preds, names)
    assert list(got) == list(want)
    for key in want:
        assert list(got[key]) == list(want[key])
        for h in want[key]:
            assert abs(got[key][h] - want[key][h]) <= 1e-12, (key, h)


# ---------------------------------------------------------------- RadNER, RadGraph


def test_radner_entities_match_jax(labelers):
    texts = REFS + HYPS
    jtok = labelers["jner"].tokenizer
    ttok = labelers["tner"].tokenizer
    for text in texts:
        for w in text.lower().split():
            assert ttok.encode(w, add_special_tokens=False) == \
                jtok.encode(w, add_special_tokens=False), w
    want = labelers["jner"].extract(texts)
    got = labelers["tner"].extract(texts)
    assert got == want
    labels = {label for doc in got for s in doc for _, label in s["entities"]}
    assert {"ANAT-DP", "OBS-DP"} <= labels  # entities of both families


def test_span_decoding_matches_jax():
    rng = np.random.default_rng(0)
    tags = ["O", "0", "O-x", "S-ANATOMY", "B-ANAT-DP", "I-ANAT-DP", "I-OBS-DP", "OBS-DA"]
    for _ in range(50):
        tagged = [(f"w{i}", str(rng.choice(tags))) for i in range(int(rng.integers(0, 12)))]
        assert TRadNER._decode_entities(tagged) == JRadNER._decode_entities(tagged)


@pytest.mark.parametrize("level", ["all", "simple", "partial", "complete"])
def test_radgraph_rewards_match_jax(labelers, scorer_env, level):
    want = jclinical.F1RadGraph(reward_level=level)(refs=REFS, hyps=HYPS)
    got = tclinical.F1RadGraph(reward_level=level, device="cpu")(refs=REFS, hyps=HYPS)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2] and got[3] == want[3]
    assert (max(got[0]) if level == "all" else got[0]) > 0


def test_radgraph_relation_rules_match_jax(labelers):
    docs = labelers["tner"].extract(REFS + HYPS)
    docs.append([{"text": "opacity suggestive of pneumonia.",
                  "entities": [("opacity", "OBS-DP"), ("pneumonia", "OBS-U"),
                               ("lung", "ANAT-DP")]}])
    for relations in ("heuristic", "none"):
        for doc in docs:
            assert tradgraph.annotation_from_ner(doc, relations) == \
                jradgraph.annotation_from_ner(doc, relations)


# ---------------------------------------------------------------- NLI, the entity metrics


def test_nli_labels_match_jax(labelers):
    sentences = [s for r in REFS + HYPS for s in r.split(" . ") if s]
    rng = np.random.default_rng(3)
    premises = list(rng.choice(sentences, 40))
    hypotheses = list(rng.choice(sentences, 40))
    want = labelers["jnli"].predict(premises, hypotheses)
    got = labelers["tnli"].predict(premises, hypotheses)
    assert got == want
    assert len(set(got)) >= 2


def test_radentity_metrics_match_jax(labelers, scorer_env):
    want = jnli.RadEntityMatchExactImpl(ner=labelers["jner"])(REFS, HYPS)
    got = tnli.RadEntityMatchExactImpl(ner=labelers["tner"])(REFS, HYPS)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL_SCORE)
    assert abs(got[0] - want[0]) <= TOL_SCORE and got[0] > 0
    want = jnli.RadEntityNLIImpl(ner=labelers["jner"], nli=labelers["jnli"])(REFS, HYPS)
    got = tnli.RadEntityNLIImpl(ner=labelers["tner"], nli=labelers["tnli"], device="cpu")(
        REFS, HYPS)
    assert len(got[1]) == len(want[1]) == len(REFS) - 1  # the empty hypothesis: no score
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL_SCORE)
    assert abs(got[0] - want[0]) <= TOL_SCORE and got[0] > 0


class _FakeNER:
    def __init__(self, table):
        self.table = table

    def extract(self, reports):
        return [self.table[r] for r in reports]


class _FakeNLI:
    def __init__(self, verdicts):
        self.verdicts = verdicts
        self.calls = 0

    def predict(self, premises, hypotheses):
        self.calls += 1
        return [self.verdicts.get((p, h), "neutral") for p, h in zip(premises, hypotheses)]


def test_radentity_arithmetic_matches_jax_on_the_reference_toys():
    """The published self-check (0.7) of RadEntityMatchExact and the NLI
    gating of ``tests/test_clinical_scorers.py``; the port asks its NLI
    once for all pairs."""
    def doc(*sents):
        return [{"text": t, "entities": e} for t, e in sents]

    table = {
        "h1": doc(("no pleural effusion.", [("effusion", "S-OBSERVATION"),
                                            ("pleural", "S-ANATOMY")])),
        "r1": doc(("no pleural effusions.", [("effusion", "S-OBSERVATION"),
                                             ("effusions", "S-OBSERVATION"),
                                             ("pleura", "S-ANATOMY")])),
        "h2": doc(("effusion seen.", [("effusion", "S-OBSERVATION")]),
                  ("heart normal.", [("heart", "S-ANATOMY")])),
        "r2": doc(("no effusion.", [("effusion", "S-OBSERVATION")]),
                  ("heart enlarged.", [("heart", "S-ANATOMY")])),
    }
    got = tclinical.RadEntityMatchExact(ner=_FakeNER(table))(refs=["r1", "r2"], hyps=["h1", "h2"])
    want = jclinical.RadEntityMatchExact(ner=_FakeNER(table))(refs=["r1", "r2"],
                                                              hyps=["h1", "h2"])
    assert got[1] == want[1] and got[1][0] == pytest.approx(0.4)

    def scorer(cands, refs):
        return [1.0 if c.split()[-1] == r.split()[-1] else
                (0.9 if c.split()[0] == r.split()[0] else 0.1) for c, r in zip(cands, refs)]

    verdicts = {("effusion seen.", "no effusion."): "contradiction",
                ("heart normal.", "heart enlarged."): "entailment",
                ("no effusion.", "effusion seen."): "contradiction",
                ("heart enlarged.", "heart normal."): "entailment"}
    for v in (verdicts, {k: "contradiction" for k in verdicts}, {}):
        nli = _FakeNLI(v)
        got = tclinical.RadEntityNLI(ner=_FakeNER(table), nli=nli, sentence_scorer=scorer)(
            refs=["r1", "r2"], hyps=["h1", "h2"])
        want = jclinical.RadEntityNLI(ner=_FakeNER(table), nli=_FakeNLI(v),
                                      sentence_scorer=scorer)(refs=["r1", "r2"],
                                                              hyps=["h1", "h2"])
        assert got == want and nli.calls == 1


def test_stanford_ct_abd_matches_jax():
    refs = REFS + ["hepatomegaly and ascites .", "no free fluid ."]
    hyps = HYPS + ["liver lesion with free fluid .", "splenomegaly ."]
    assert tclinical.StanfordCTAbdAcc()(refs, hyps) == jclinical.StanfordCTAbdAcc()(refs, hyps)


# ---------------------------------------------------------------- compute_scores


def _compute(fn, metrics, **kwargs):
    return fn(metrics, REFS, HYPS, split="validate", seed=0, config={}, epoch=0,
              logger=logging.getLogger("clinical_test"), dump=False, **kwargs)


def test_compute_scores_clinical_keys_match_jax(scorer_env):
    want = _compute(jcompute, CLINICAL)
    got = _compute(tcompute, CLINICAL, device="cpu")
    assert list(got) == list(want) == METRIC_KEYS + ["stanford_ct_abd"]
    for key in want:
        assert want[key] is not None and abs(got[key] - want[key]) <= TOL_SCORE, key


def test_compute_scores_dumps_the_chexbert_labels(scorer_env, tmp_path):
    from vilmedic_torch.utils import set_logger

    logger = set_logger(str(tmp_path), "clinical-dump")
    tcompute(["chexbert"], REFS, HYPS, "validate", "s", {}, 1, logger, device="cpu")
    labels = tchexbert.CheXbert(device="cpu").get_labels(REFS)
    assert (tmp_path / "validate_s_refs.chexbert.txt").read_text() == "\n".join(map(str, labels))
    assert (tmp_path / "validate_s_hyps.chexbert.txt").exists()


def test_missing_weights_read_none_like_jax(scorer_env, monkeypatch, tmp_path):
    monkeypatch.setenv("VILMEDIC_WEIGHTS_DIR", str(tmp_path / "nothing"))
    metrics = CLINICAL[:4] + ["BLEU"]
    want = _compute(jcompute, metrics)
    got = _compute(tcompute, metrics, device="cpu")
    assert list(got) == list(want)
    assert [k for k, v in got.items() if v is None] == CLINICAL[:4]
    assert got["BLEU"] == want["BLEU"]


def test_unported_clinical_names_still_raise():
    with pytest.raises(NotImplementedError, match="radevalbertscore"):
        _compute(tcompute, ["chexbert", "radevalbertscore"], device="cpu")


def test_scoring_loads_no_transformers_sklearn_or_hub(scorer_env):
    """The clinical metrics, computed by the port in a fresh process, import
    none of ``transformers``, ``sklearn``, ``huggingface_hub``,
    ``safetensors``, ``jax`` or the JAX package."""
    code = (
        "import sys, logging\n"
        "from vilmedic_torch.scorers.scores import compute_scores\n"
        f"s = compute_scores({CLINICAL!r}, {REFS!r}, {HYPS!r}, 'v', 0, {{}}, 0,\n"
        "                   logging.getLogger('x'), dump=False, device='cpu')\n"
        "assert all(v is not None for v in s.values()), s\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('transformers', 'sklearn',\n"
        "       'huggingface_hub', 'safetensors', 'jax', 'flax', 'vilmedic_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]


# ---------------------------------------------------------------- SCST rewards


class _Tok:
    def decode(self, row, **kw):
        return (REFS + HYPS)[int(row[0])]


def _scst(module, **kw):
    return module.SCST(tokenizer=_Tok(), max_length=4, bos_token_id=0, eos_token_id=2,
                       pad_token_id=1, **kw)


@pytest.mark.parametrize("score,args", [
    ("chexbert", None), ("radgraph", {"reward_level": "partial"}),
    ("radgraph", {"reward_level": "complete"}), ("radentitymatchexact", None),
    ("radentitynli", None), ("bertscore", None)])
def test_scst_rewards_match_jax(scorer_env, monkeypatch, score, args):
    from vilmedic_torch.blocks.rl import scst as tscst
    from vilmedic_tpu.blocks.rl import scst as jscst

    monkeypatch.setenv("BERTSCORE_BASELINE", "0.1,0.2,0.3")
    rollouts = np.arange(12, 24)[:, None]  # the hypotheses but the empty one
    rollouts[5] = 0
    refs = np.arange(12)[:, None]
    want = _scst(jscst, scores=[score], scores_args=args)
    got = _scst(tscst, scores=[score], scores_args=args, device="cpu")
    (w,), wh, wr = want.get_reward(rollouts, refs)
    (g,), gh, gr = got.get_reward(rollouts, refs)
    assert (gh, gr) == (wh, wr)
    assert g.dtype == w.dtype == np.float32 and g.shape == (12,)
    assert len(set(g.tolist())) > 1  # rewards that tell the samples apart
    if score in ("chexbert", "radgraph", "radentitymatchexact"):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_SCORE)


def test_radgraph_default_reward_is_a_reference_defect(scorer_env):
    """``radgraph`` without ``scores_args`` (``reward_level="all"``): the
    JAX package's reward is (3, B), which its iteration stacks into (1, 3,
    B) advantages (summing the levels in the loss) or, beside another
    reward, cannot stack at all. The port refuses it, naming
    ``scores_args``."""
    from vilmedic_torch.blocks.rl import scst as tscst
    from vilmedic_tpu.blocks.rl import scst as jscst

    rollouts, refs = np.arange(12, 16)[:, None], np.arange(4)[:, None]
    (radgraph,), _, _ = _scst(jscst, scores=["radgraph"]).get_reward(rollouts, refs)
    assert radgraph.shape == (3, 4)
    jboth = _scst(jscst, scores=["rougel", "radgraph"], scores_weights=[0.5, 0.5])
    reward_g, _, _ = jboth.get_reward(rollouts, refs)
    reward_s, _, _ = jboth.get_reward(rollouts[::-1], refs)
    with pytest.raises(ValueError):
        np.stack([rs - rg for rs, rg in zip(reward_s, reward_g)])
    with pytest.raises(ValueError, match="scores_args"):
        _scst(tscst, scores=["radgraph"], device="cpu")
    with pytest.raises(ValueError, match="scores_args"):
        _scst(tscst, scores=["rougel", "radgraph"], scores_weights=[0.5, 0.5],
              scores_args=[None, {"reward_level": "all"}], device="cpu")


# ---------------------------------------------------------------- the train CLI

ROBERTA_TINY = {"model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
                "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 64, "max_position_embeddings": 64, "layer_norm_eps": 1e-5,
                "vocab_size": 50265, "type_vocab_size": 1, "hidden_dropout_prob": 0.0,
                "attention_probs_dropout_prob": 0.0}
CLI_SEED = 515151
TINY_DENSENET = (8, (2, 2), 16)


def _cli_config(root, ckpt_dir, decoder):
    """``config/RRG/biomed-roberta-baseline-mimic.yml`` at 2 decoder layers of
    32 (its pretrained name pointed at ``decoder``) over ``densenet_tiny``,
    the corpus vocabulary, one epoch, the Validator at beam 2 with the
    config's eight metrics and early stop as written; one file without
    RAdam's ``weight_decay``, which the JAX package's ``optax.radam``
    rejects."""
    import yaml

    from vilmedic_tpu.config.config import load_config

    overrides = [
        f"ckpt_dir={ckpt_dir}", "name=roberta", f"seed={CLI_SEED}", "model.dtype=float32",
        f"model.decoder.proto={decoder}", f"dataset.image.root={root}",
        "dataset.image.resize=40", "dataset.image.crop=32", f"dataset.seq.root={root}",
        "dataset.seq.file=report.tok", "dataset.seq.tokenizer=null",
        "dataset.seq.tokenizer_max_len=24", "dataset.num_workers=0",
        "model.cnn.backbone=densenet_tiny", "model.cnn.visual_projection.in_features=32",
        "model.cnn.visual_projection.out_features=32", "trainor.batch_size=4",
        "trainor.epochs=0", "trainor.optim_params.lr=0.001", "validator.batch_size=4",
        "validator.beam_width=2", "validator.shard_eval=false", "ensemblor.beam_width=2",
        "ensemblor.splits=[validate]"]
    config, _ = load_config("config/RRG/biomed-roberta-baseline-mimic.yml", overrides)
    config = config.to_dict()
    del config["trainor"]["optim_params"]["weight_decay"]
    path = Path(ckpt_dir) / "config.yml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module")
def cli_runs(weights_dir, tmp_path_factory):
    """The config through the JAX package's Trainor + Validator (as
    ``bin_tpu/train.py`` builds them) and the port's CLI, from the same
    initial weights."""
    from PIL import Image

    import vilmedic_torch.bin.train as tcli
    import vilmedic_torch.blocks.vision.densenet as tdensenet
    import vilmedic_tpu.blocks.vision.densenet as jdensenet
    from vilmedic_torch.executors import Trainor as TTrainor
    from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
    from vilmedic_tpu.config.config import executor_config, load_config
    from vilmedic_tpu.executors import Trainor as JTrainor
    from vilmedic_tpu.executors import Validator as JValidator
    from vilmedic_tpu.utils import set_logger as jset_logger

    root = tmp_path_factory.mktemp("roberta_cli")
    rng = np.random.default_rng(0)
    reports = [r.lower() for r in REFS[:8]]
    paths = []
    for i in range(len(reports)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.report.tok").write_text("\n".join(reports))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
    decoder = root / "roberta"
    decoder.mkdir()
    (decoder / "config.json").write_text(json.dumps(ROBERTA_TINY))

    with pytest.MonkeyPatch.context() as mp:
        for key in SCORER_ENV:
            mp.delenv(key, raising=False)
        mp.setenv("VILMEDIC_WEIGHTS_DIR", str(weights_dir))
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY_DENSENET)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY_DENSENET)

        jdir = tmp_path_factory.mktemp("jax_run")
        config, _ = load_config(_cli_config(root, jdir, decoder))
        train_config = executor_config(config, "trainor")
        val_config = executor_config(config, "validator")
        jrun = os.path.join(config.ckpt_dir, config.name)
        os.makedirs(jrun)
        train_config.ckpt_dir = val_config.ckpt_dir = jrun
        jset_logger(jrun, CLI_SEED)
        jtrainor = JTrainor(config=train_config, seed=CLI_SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(CLI_SEED)
        jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                        train_dl=jtrainor.dl, seed=CLI_SEED, from_training=True)
        initial = {k: np.array(v) for k, v in rrg_state_dict_from_jax(
            {"params": jtrainor.model.variables["params"],
             "batch_stats": jtrainor.model.variables["batch_stats"]}).items()}
        jtrainor.start()

        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)

        mp.setattr(tcli, "Trainor", Seeded)
        tdir = tmp_path_factory.mktemp("torch_run")
        ttrainor = tcli.main([_cli_config(root, tdir, decoder), "device=cpu"])

        # without the scorers' weights the early-stop metric is missing
        mp.setenv("VILMEDIC_WEIGHTS_DIR", str(root / "no_weights"))
        try:
            tcli.main([_cli_config(root, tmp_path_factory.mktemp("torch_bare"), decoder),
                       "device=cpu"])
            bare = None
        except KeyError as e:
            bare = e
        mp.setenv("VILMEDIC_WEIGHTS_DIR", str(weights_dir))
        from vilmedic_torch.bin import ensemble as tensemble

        ensemble = tensemble.main([_cli_config(root, tdir, decoder), "device=cpu"])
        yield dict(j=jtrainor, t=ttrainor, jdir=jrun, tdir=os.path.join(str(tdir), "roberta"),
                   bare=bare, ensemble=ensemble)


def _read(run_dir, kind):
    with open(os.path.join(run_dir, f"validate_{CLI_SEED}_{kind}")) as f:
        return f.read()


def test_roberta_cli_scores_the_eight_metrics_like_jax(cli_runs):
    jdir, tdir = cli_runs["jdir"], cli_runs["tdir"]
    assert _read(tdir, "hyps.txt") == _read(jdir, "hyps.txt")
    assert _read(tdir, "refs.chexbert.txt") == _read(jdir, "refs.chexbert.txt")
    assert _read(tdir, "hyps.chexbert.txt") == _read(jdir, "hyps.chexbert.txt")
    # the first record: the training run's Validator (the ensemble CLI appends its own)
    want, got = (json.JSONDecoder().raw_decode(_read(d, "metrics.txt"))[0] for d in (jdir, tdir))
    assert (got["split"], got["epoch"]) == (want["split"], want["epoch"])
    assert list(got["scores"]) == list(want["scores"])
    assert sorted(got["scores"]) == sorted(["ROUGEL", "BLEU", "METEOR", "CIDERD"] + METRIC_KEYS)
    for key, value in want["scores"].items():
        assert value is not None and abs(got["scores"][key] - value) <= TOL_SCORE, key
    jsched, tsched = cli_runs["j"].training_scheduler, cli_runs["t"].training_scheduler
    assert tsched.early_stop_metric == "chexbert-5_micro avg_f1-score"
    assert abs(tsched.current_best_metric - jsched.current_best_metric) <= TOL_SCORE


def test_missing_early_stop_metric_raises_like_jax(cli_runs):
    """Without the weights ``chexbert`` reads ``None`` under its own name,
    so the early-stop key is missing: the JAX Trainor's
    ``np.mean([s[early_stop_metric] ...])`` raises ``KeyError``, and so does
    the port's."""
    assert isinstance(cli_runs["bare"], KeyError)
    assert "chexbert-5_micro avg_f1-score" in str(cli_runs["bare"])


def test_ensemble_cli_scores_the_clinical_metrics(cli_runs):
    """The ensemble CLI over the run's best (only) checkpoint, at the
    Validator's beam, scores the eight metrics as the training run's
    Validator did."""
    got = cli_runs["ensemble"].scores[0]
    want = cli_runs["t"].evaluator.scores[0]
    assert sorted(got) == sorted(want) and len(got) == 14
    for key, value in want.items():
        assert got[key] is not None and abs(got[key] - value) <= 1e-12, key


def test_metrics_cli_scores_the_clinical_metrics_like_jax(scorer_env, tmp_path, capsys):
    """``vilmedic_metrics`` over two text files, the port's (``--device
    cpu``) against ``bin_tpu/vilmedic_metrics.py``."""
    import importlib.util

    from vilmedic_torch.bin import vilmedic_metrics as tmetrics

    spec = importlib.util.spec_from_file_location("jmetrics", REPO / "bin_tpu" /
                                                  "vilmedic_metrics.py")
    jmetrics = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmetrics)
    (tmp_path / "h.txt").write_text("\n".join(HYPS[:5] + HYPS[6:]))
    (tmp_path / "r.txt").write_text("\n".join(REFS[:5] + REFS[6:]))
    args = ["--hyps", str(tmp_path / "h.txt"), "--refs", str(tmp_path / "r.txt"),
            "--metrics", "BLEU", *CLINICAL]
    jmetrics.main(args)
    want = json.loads(capsys.readouterr().out)
    got = tmetrics.main(args + ["--device", "cpu"])
    assert list(got) == list(want) == ["BLEU"] + METRIC_KEYS + ["stanford_ct_abd"]
    for key, value in want.items():
        assert value is not None and abs(got[key] - value) <= TOL_SCORE, key
