"""The port's multi-process training and evaluation (``vilmedic_torch.parallel``)
against the JAX package, on the CPU with gloo.

- ``param_specs``: the port's placements read as the JAX package's specs on
  one RRS tree (Flax paths renamed as ``zoo/from_jax.py`` renames them);
- two processes (``torchrun``'s environment, gloo) run the gathers, the
  broadcast, the global mean and the gradient all-reduce, and
  ``shard_params`` places a block's weights over a 1-D ``DeviceMesh``;
- two processes train through the train CLI, each on its strided shard of
  the global batch: the RRS at width 32 (``tests/test_multihost_train.py``'s
  corpus), a ``densenet_tiny`` RRG, whose BatchNorm takes the global
  batch's moments, the MVQA config (label smoothing, a ResNet), and
  ConVIRT and GLoRIA, whose contrastive losses run over both processes'
  rows. Both start from the JAX model's initial state carried
  across with ``zoo/from_jax.py``; the per-epoch losses of both ranks are
  equal, and within 1e-5 relative of a single-process JAX run on the same
  global batch, the ranks' final parameters are bitwise equal, the scores
  agree, and process 0 alone wrote the checkpoint. The five families run
  at once, each in processes of its own (the JAX run, then the two ranks;
  the module fixture ``two_process_runs``), and each test checks one;
- ``shard_eval``: with two local devices (the CPU, twice) the beam search,
  padded and split, gives the unsharded sequences, and the classifier
  evaluation its logits within 1e-6 (a product over fewer rows may round
  an f32 logit differently).
"""

import glob
import json
import os
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import yaml

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.parallel import mesh, param_specs
from vilmedic_torch.zoo.from_jax import _flatten, _param
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.parallel import param_specs as jparam_specs
from vilmedic_tpu.utils import set_logger as jset_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 881100
TINY = (8, (2, 2), 16)
TOL_LOSS = 1e-5
FINDINGS = ["the lungs are well expanded and clear .", "heart size is mildly enlarged .",
            "there is a small left pleural effusion .", "no pneumothorax is identified .",
            "the cardiomediastinal silhouette is normal .",
            "patchy opacity in the right lower lobe .", "lungs are clear without effusion .",
            "stable cardiomegaly without edema ."]
IMPRESSIONS = ["no acute disease .", "cardiomegaly .", "small left effusion .",
               "no pneumothorax .", "normal heart .", "possible pneumonia .",
               "clear lungs .", "stable cardiomegaly ."]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script: str, args, nproc: int = 2, timeout: int = 300, env=None):
    """``script`` in ``nproc`` processes under torchrun's environment (over
    ``env``, by default this process's); returns each rank's ``RESULT``
    JSON."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        rank_env = dict(env or os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, "-c", script, *args], cwd=REPO,
                                      env=rank_env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    return results


# ---------------------------------------------------------------- sharding rules

def test_param_specs_match_the_jax_package():
    from vilmedic_torch.models.rrs import RRS as TRRS
    from vilmedic_torch.zoo.from_jax import rrs_state_dict_from_jax
    from vilmedic_tpu.models.rrs import RRS as JRRS

    block = dict(proto=None, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=32, vocab_size=50)
    jmodel = JRRS(encoder=dict(block), decoder=dict(block), dtype="float32")
    batch = {k: np.ones((2, 6), np.int32) for k in
             ("input_ids", "attention_mask", "decoder_input_ids", "decoder_attention_mask")}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
    want = {_param(path, leaf)[0]: tuple(spec) for path, (spec, leaf) in _flatten(
        jax.tree.map(lambda s, x: (s, x), jparam_specs(variables["params"]),
                     variables["params"], is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))}
    tmodel = TRRS(encoder=dict(block), decoder=dict(block), dtype="float32", device="cpu")
    tmodel.module.load_state_dict(rrs_state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    got = param_specs(tmodel.module)
    assert sorted(got) == sorted(want)
    assert got == want
    sharded = {k for k, v in got.items() if v}
    assert any(k.endswith("q.weight") for k in sharded) and any(
        k.endswith("fc2.weight") for k in sharded) and any("lm_head" in k for k in sharded)


# ---------------------------------------------------------------- collectives

GATHERS = r'''
import json, sys
import numpy as np, torch
from vilmedic_torch.parallel import mesh
assert mesh.init_distributed("cpu") and mesh.process_count() == 2
r = mesh.process_index()
out = {"rank": r}
out["strings"] = mesh.gather_string_lists([f"r{r}-{i} é" for i in range(r + 2)])
out["arrays"] = mesh.gather_arrays(np.arange(3 * (r + 1)).reshape(r + 1, 3) + 10 * r).tolist()
out["mean"] = mesh.gather_weighted_mean(1.0 + r, 1.0 + 3 * r)
out["json"] = mesh.broadcast_json({"rank": r, "x": [r, 2.5]})
out["allgather"] = mesh.process_allgather({"a": np.full(2, r)})["a"].tolist()
g = [torch.full((2, 3), float(r + 1)), torch.arange(4, dtype=torch.float64) * (r + 1)]
mesh.all_reduce_sum_(g)
out["reduced"] = [t.tolist() for t in g]
total = torch.tensor(6.0 * (r + 1), requires_grad=True)
with mesh.global_batch():
    share = mesh.global_mean(total, torch.tensor(2 + 2 * r))
share.backward()
out["share"], out["share_grad"] = float(share), float(total.grad)
out["local_batch"] = mesh.local_batch_size(8)
from torch.distributed.device_mesh import init_device_mesh
from vilmedic_torch.parallel import shard_params
torch.manual_seed(0)
block = torch.nn.ModuleDict({"q": torch.nn.Linear(4, 6), "fc2": torch.nn.Linear(6, 4),
                             "ln": torch.nn.LayerNorm(4)})
full = {n: p.detach().clone() for n, p in block.named_parameters()}
shard_params(block, init_device_mesh("cpu", (2,), mesh_dim_names=("model",)))
out["shards"] = {n: list(p.to_local().shape) for n, p in block.named_parameters()}
out["whole"] = all(torch.equal(p.full_tensor(), full[n]) for n, p in block.named_parameters())
print("RESULT " + json.dumps(out))
mesh.destroy()
'''


def test_two_process_collectives():
    r0, r1 = _run_ranks(GATHERS, [])
    for r in (r0, r1):
        assert r["strings"] == ["r0-0 é", "r0-1 é", "r1-0 é", "r1-1 é", "r1-2 é"]
        assert r["arrays"] == [[0, 1, 2], [10, 11, 12], [13, 14, 15]]
        assert r["mean"] == pytest.approx((1 * 1 + 2 * 4) / 5)
        assert r["json"] == {"rank": 0, "x": [0, 2.5]}
        assert r["allgather"] == [[0, 0], [1, 1]]
        assert r["reduced"] == [[[3.0] * 3] * 2, [0.0, 3.0, 6.0, 9.0]]
        assert r["share_grad"] == pytest.approx(1 / 6) and r["local_batch"] == 4
        # q (column): Shard(0) of the (out, in) weight; fc2 (row): Shard(1)
        assert r["shards"] == {"q.weight": [3, 4], "q.bias": [6], "fc2.weight": [4, 3],
                               "fc2.bias": [4], "ln.weight": [4], "ln.bias": [4]}
        assert r["whole"]
    # the shares of the global mean (6 + 12) / (2 + 4) add up to it
    assert r0["share"] + r1["share"] == pytest.approx(3.0)


# ---------------------------------------------------------------- training

TRAIN = r'''
import json, os, sys
import torch
import vilmedic_torch.bin.train as tcli
import vilmedic_torch.blocks.vision.densenet as tdensenet
from vilmedic_torch.executors import Trainor
from vilmedic_torch.parallel import mesh
tdensenet.CONFIGS["densenet_tiny"] = (8, (2, 2), 16)
initial = torch.load(sys.argv[1])

class Seeded(Trainor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.module.load_state_dict(initial, strict=True)

tcli.Trainor = Seeded
t = tcli.main(json.loads(sys.argv[2]))
state = {k: v.double().sum().item() for k, v in t.model.module.state_dict().items()}
print("RESULT " + json.dumps({"rank": mesh.process_index(), "losses": t.epoch_losses,
                              "scores": t.evaluator.scores[-1], "state": state}))
mesh.destroy()
'''

# the JAX package's single-process run of one family, in a process of its own
# with the suite's JAX settings (tests/conftest.py)
JAX_RUN = r'''
import json, sys
sys.path.insert(0, "tests")
import conftest
import test_torch_parallel as t
losses, scores = t._jax_reference(sys.argv[1], sys.argv[2])
print("RESULT " + json.dumps({"losses": losses, "scores": scores}))
'''

FAMILIES = ("rrs", "rrg", "mvqa", "convirt", "gloria")


def _setup_rrs(tmp, write):
    data = tmp / "data"
    if write:
        data.mkdir()
        for split in ("train", "validate"):
            (data / f"{split}.findings.tok").write_text("\n".join(FINDINGS * 2))
            (data / f"{split}.impression.tok").write_text("\n".join(IMPRESSIONS * 2))
    block = ["hidden_size=32", "num_hidden_layers=1", "num_attention_heads=4",
             "intermediate_size=64", "max_position_embeddings=32", "hidden_dropout_prob=0.0"]

    def overrides(ckpt_dir):
        return [
            f"ckpt_dir={ckpt_dir}", "name=rrs", f"seed={SEED}", "model.dtype=float32",
            f"dataset.src.root={data}", f"dataset.tgt.root={data}",
            "dataset.src.file=findings.tok", "dataset.tgt.file=impression.tok",
            "dataset.src.tokenizer_max_len=24", "dataset.tgt.tokenizer_max_len=8",
            "dataset.num_workers=0", *[f"model.encoder.{kv}" for kv in block],
            *[f"model.decoder.{kv}" for kv in block], "trainor.batch_size=8",
            "trainor.epochs=1", "trainor.optim_params.lr=0.001", "trainor.optimizer=Adam",
            "trainor.early_stop_metric=ROUGEL", "validator.batch_size=4",
            "validator.beam_width=2", "validator.metrics=[ROUGEL]", "validator.shard_eval=false"]

    config_file = "config/RRS/baseline-transformer-mimic.yml"
    return ([config_file, *overrides(tmp / "jax")],
            [config_file, *overrides(tmp / "port"), "device=cpu"], "ROUGEL")


def _setup_rrg(tmp, write):
    """A ``densenet_tiny`` RRG: BatchNorm's moments over both processes'
    rows give the JAX package's global-batch statistics (``.npy`` images:
    no random crop or flip, so the shards see the JAX batch's images). The
    flagship config without RAdam's weight_decay, which optax.radam
    rejects."""
    data = tmp / "data"

    def overrides(ckpt_dir):
        return [
            f"ckpt_dir={ckpt_dir}", "name=rrg", f"seed={SEED}", "model.dtype=float32",
            f"dataset.image.root={data}", "dataset.image.file=image.npy",
            "dataset.image.ext=.npy", f"dataset.seq.root={data}", "dataset.seq.file=report.tok",
            "dataset.seq.tokenizer_max_len=10", "dataset.num_workers=0",
            "model.cnn.backbone=densenet_tiny", "model.cnn.visual_projection.in_features=32",
            "model.cnn.visual_projection.out_features=32", "model.decoder.hidden_size=32",
            "model.decoder.num_attention_heads=4", "model.decoder.intermediate_size=64",
            "model.decoder.max_position_embeddings=64", "model.decoder.hidden_dropout_prob=0.0",
            "trainor.batch_size=8", "trainor.epochs=1", "trainor.optim_params.lr=0.001",
            "trainor.early_stop_metric=ROUGEL", "validator.batch_size=4",
            "validator.beam_width=2", "validator.metrics=[ROUGEL]",
            "validator.shard_eval=false"]

    def config_file(ckpt_dir):
        path = tmp / f"{os.path.basename(str(ckpt_dir))}.yml"
        if write:
            config, _ = load_config("config/RRG/baseline-mimic.yml", overrides(ckpt_dir))
            config = config.to_dict()
            del config["trainor"]["optim_params"]["weight_decay"]
            path.write_text(yaml.safe_dump(config))
        return str(path)

    if write:
        data.mkdir()
        rng = np.random.default_rng(0)
        for split in ("train", "validate"):
            np.save(data / f"{split}.image.npy",
                    rng.standard_normal((16, 32, 32, 3)).astype(np.float32))
            (data / f"{split}.report.tok").write_text("\n".join(IMPRESSIONS * 2))
    return [config_file(tmp / "jax")], [config_file(tmp / "port"), "device=cpu"], "ROUGEL"


def _setup_mvqa(tmp, write):
    """``config/MVQA/vqa.yml`` cut down (resnet18, 3 classes): its label
    smoothing's row means and the ResNet's BatchNorm over both processes,
    the Validator's logits and labels gathered as arrays. Adam's eps 1, as
    in ``tests/test_torch_mvqa.py`` (BatchNorm biases whose gradients nearly
    cancel)."""
    data = tmp / "data"
    if write:
        data.mkdir()
        rng = np.random.default_rng(1)
        for split in ("train", "validate"):
            np.save(data / f"{split}.image.npy",
                    rng.standard_normal((16, 32, 32, 3)).astype(np.float32))
            (data / f"{split}.label.tok").write_text("\n".join(["a", "b", "c", "b"] * 4))

    def overrides(ckpt_dir):
        return [
            f"ckpt_dir={ckpt_dir}", "name=mvqa", f"seed={SEED}", "model.dtype=float32",
            f"dataset.image.root={data}", "dataset.image.file=image.npy",
            "dataset.image.ext=.npy", f"dataset.label.root={data}", "dataset.num_workers=0",
            "model.cnn.backbone=resnet18", "model.cnn.output_layer=layer3",
            "model.adapter.input_size=256", "model.adapter.output_size=32",
            "model.transformer.hidden_size=32", "model.transformer.intermediate_size=64",
            "model.transformer.num_attention_heads=4", "model.transformer.num_hidden_layers=1",
            "model.transformer.hidden_dropout_prob=0.0", "model.classifier.num_classes=3",
            "trainor.batch_size=8", "trainor.epochs=1", "trainor.optim_params.eps=1.0",
            "validator.batch_size=4", "validator.shard_eval=false"]

    config_file = "config/MVQA/vqa.yml"
    return ([config_file, *overrides(tmp / "jax")],
            [config_file, *overrides(tmp / "port"), "device=cpu"], "accuracy")


def _setup_selfsup(tmp, write, kind):
    """``config/SELFSUP/{kind}-mimic.yml`` cut down (width 32, resnet18,
    ``.npy`` images, the corpus vocabulary): the contrastive loss over both
    processes' rows (``mesh.loss_over_global_rows``) and the ResNet's
    BatchNorm over both give the losses of one JAX process on the global
    batch. GLoRIA with Adam's eps 1 (``tests/test_torch_selfsup.py``). The
    validation scores are the processes' own (a contrastive loss over each
    process's shard of a validation batch, as the JAX package's
    multi-process evaluation takes it), held across the ranks only."""
    data = tmp / "data"
    if write:
        data.mkdir()
        (tmp / "hf_cache").mkdir()  # the encoders' pretrained names resolve nowhere
        rng = np.random.default_rng(2)
        for split in ("train", "validate"):
            np.save(data / f"{split}.image.npy",
                    rng.standard_normal((16, 64, 64, 3)).astype(np.float32))
            (data / f"{split}.report.tok").write_text("\n".join(
                ["no acute disease .", "heart size is normal .", "small pleural effusion .",
                 "lungs are clear .", "mild cardiomegaly .", "no pneumothorax .",
                 "no evidence of pneumonia .", "stable cardiomegaly ."] * 2))

    def overrides(ckpt_dir):
        out = [f"ckpt_dir={ckpt_dir}", f"name={kind}", f"seed={SEED}", "model.dtype=float32",
               f"dataset.image.root={data}", f"dataset.seq.root={data}",
               "dataset.image.file=image.npy", "dataset.image.ext=.npy",
               "dataset.num_workers=0", "dataset.seq.tokenizer=null",
               "model.encoder.hidden_size=32", "model.encoder.num_hidden_layers=1",
               "model.encoder.num_attention_heads=4", "model.encoder.intermediate_size=64",
               "model.encoder.hidden_dropout_prob=0.0", "model.cnn.backbone=resnet18",
               "trainor.batch_size=8", "trainor.epochs=0", "validator.batch_size=8"]
        if kind == "gloria":
            return out + ["model.cnn.feature_dim=16", "trainor.optim_params.eps=1.0"]
        return out + ["model.projection.projection_dim=16"]

    config_file = f"config/SELFSUP/{kind}-mimic.yml"
    return ([config_file, *overrides(tmp / "jax")],
            [config_file, *overrides(tmp / "port"), "device=cpu"], None)


def _setup(kind, tmp, write=False):
    """The family's data (written once) and configs: the JAX run's config
    and overrides, the port's train CLI arguments, the score held against
    the JAX run's (None: across the ranks only)."""
    if kind in ("convirt", "gloria"):
        return _setup_selfsup(tmp, write, kind)
    return {"rrs": _setup_rrs, "rrg": _setup_rrg, "mvqa": _setup_mvqa}[kind](tmp, write)


def _env(kind, tmp):
    """The family's processes' environment: the self-supervised encoders'
    pretrained names resolve to an empty hub cache."""
    env = dict(os.environ)
    if kind in ("convirt", "gloria"):
        env.update(HF_HUB_CACHE=str(tmp / "hf_cache"), TRANSFORMERS_CACHE=str(tmp / "hf_cache"))
    return env


def _jax_reference(kind, tmp):
    """The JAX package's single-process run of the family on the global
    batch, as ``bin_tpu/train.py`` builds it; writes the port's state dict
    of its initial variables to ``tmp/initial.pt`` and returns its
    per-epoch losses and last scores."""
    from vilmedic_torch.zoo import from_jax

    tmp = pathlib.Path(tmp)
    (config_file, *overrides), _, _ = _setup(kind, tmp)
    if kind in ("convirt", "gloria"):
        import transformers.utils.hub as hf_hub

        hf_hub.TRANSFORMERS_CACHE = str(tmp / "hf_cache")
    jdensenet.CONFIGS["densenet_tiny"] = TINY
    bridge = {"rrs": from_jax.rrs_state_dict_from_jax,
              "rrg": lambda v: from_jax.rrg_state_dict_from_jax(
                  {"params": v["params"], "batch_stats": v["batch_stats"]}),
              "mvqa": lambda v: from_jax.mvqa_state_dict_from_jax(dict(v)),
              "convirt": lambda v: from_jax.convirt_state_dict_from_jax(dict(v)),
              "gloria": lambda v: from_jax.gloria_state_dict_from_jax(dict(v))}[kind]
    config, _ = load_config(config_file, overrides)
    train_config = executor_config(config, "trainor")
    val_config = executor_config(config, "validator")
    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    os.makedirs(ckpt_dir)
    train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
    jset_logger(ckpt_dir, SEED)
    jtrainor = JTrainor(config=train_config, seed=SEED)
    jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                    train_dl=jtrainor.dl, seed=SEED, from_training=True)
    initial = bridge(jax.tree.map(np.asarray, jtrainor.model.variables))
    torch.save({k: torch.as_tensor(np.asarray(x)) for k, x in initial.items()},
               tmp / "initial.pt")
    jtrainor.start()
    return ([float(x) for x in jtrainor.epoch_losses],
            json.loads(json.dumps(jtrainor.evaluator.scores[-1], default=float)))


def _family_run(kind, tmp, port_argv):
    """The JAX run, then the two port processes from its initial state."""
    env = _env(kind, tmp)
    proc = subprocess.run([sys.executable, "-c", JAX_RUN, kind, str(tmp)], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    assert proc.returncode == 0, f"the JAX run failed:\n{proc.stdout[-4000:]}"
    jax_result = json.loads([x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1][7:])
    ranks = _run_ranks(TRAIN, [str(tmp / "initial.pt"), json.dumps(port_argv)], env=env)
    return jax_result, ranks


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """Every family's JAX run and two-process port run, the families at
    once (each its own processes), started when the first test asks."""
    futures = {}
    pool = ThreadPoolExecutor(len(FAMILIES))
    for kind in FAMILIES:
        tmp = tmp_path_factory.mktemp(kind)
        _, port_argv, _ = _setup(kind, tmp, write=True)
        futures[kind] = (tmp, pool.submit(_family_run, kind, tmp, port_argv))
    yield futures
    pool.shutdown(wait=True)


def _check_two_process_run(two_process_runs, kind):
    tmp, future = two_process_runs[kind]
    jax_result, (r0, r1) = future.result()
    _, port_argv, metric = _setup(kind, tmp)
    assert r0["rank"] == 0 and r1["rank"] == 1
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == len(jax_result["losses"])
    np.testing.assert_allclose(r0["losses"], jax_result["losses"], rtol=TOL_LOSS, atol=0)
    assert r0["state"] == r1["state"]
    assert r0["scores"] == r1["scores"]
    if metric is not None:
        np.testing.assert_allclose(r0["scores"][metric], jax_result["scores"][metric],
                                   rtol=1e-12, atol=1e-12)
    ckpts = glob.glob(str(tmp / "port" / kind / "*.ckpt"))
    assert len(ckpts) == 1, ckpts


def test_two_process_rrs_training_matches_jax(two_process_runs):
    _check_two_process_run(two_process_runs, "rrs")


def test_two_process_rrg_batchnorm_training_matches_jax(two_process_runs):
    _check_two_process_run(two_process_runs, "rrg")


def test_two_process_mvqa_training_matches_jax(two_process_runs):
    _check_two_process_run(two_process_runs, "mvqa")


@pytest.mark.parametrize("kind", ["convirt", "gloria"])
def test_two_process_selfsup_training_matches_jax(two_process_runs, kind):
    _check_two_process_run(two_process_runs, kind)


# ---------------------------------------------------------------- shard_eval

def test_eval_devices_follow_shard_eval(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.eval_devices({}, "cpu") == [cpu]
    monkeypatch.setattr(mesh, "local_devices", lambda device: [cpu, cpu])
    assert mesh.eval_devices({}, "cpu") == [cpu, cpu]  # on by default over several
    assert mesh.eval_devices({"shard_eval": False}, "cpu") == [cpu]


def test_sharded_beam_search_equals_unsharded(monkeypatch):
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn, sharded_generate
    from vilmedic_torch.models.rrg import RRG as TRRG

    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
    cnn = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
               dropout_out=0.0, permute="batch_first",
               visual_projection={"in_features": 32, "out_features": 64}, freeze=False)
    decoder = dict(proto=None, hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=128, max_position_embeddings=32, vocab_size=300,
                   bos_token_id=0, eos_token_id=2, pad_token_id=1)
    model = TRRG(decoder=decoder, cnn=cnn, dtype="float32", device="cpu", seed=3)
    images = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    inputs = {"images": images, "images_mask": None}

    def make(ms):
        return make_generate_fn(ms, 4, 10, 0, 2, 1, 1.0)

    want = sharded_generate([model], [torch.device("cpu")], make)(inputs)
    got = sharded_generate([model], [torch.device("cpu")] * 2, make)(inputs)
    assert got.shape[0] == 4  # padded to a multiple of the device count
    torch.testing.assert_close(got[:3], want, rtol=0, atol=0)


def test_sharded_classifier_evaluation_equals_unsharded(monkeypatch):
    from vilmedic_torch.blocks.classifier import evaluation

    class Model:
        def __init__(self, seed):
            self.module = torch.nn.Linear(5, 3)
            torch.nn.init.normal_(self.module.weight, generator=torch.Generator().manual_seed(seed))

        def apply_eval(self, batch):
            out = self.module(batch["images"])
            return {"output": out,
                    "loss": torch.nn.functional.cross_entropy(out, batch["labels"])}

    class Loader:
        dataset = None

        def __iter__(self):
            g = torch.Generator().manual_seed(1)
            for n in (4, 4, 2):  # the last batch pads to 2 per device too
                yield {"images": torch.randn(n, 5, generator=g),
                       "labels": torch.randint(0, 3, (n,), generator=g)}

    models = [Model(0), Model(1)]
    want = evaluation(models, {"shard_eval": False}, Loader())
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device: [torch.device("cpu"), torch.device("cpu")])
    got = evaluation(models, {}, Loader())
    # a product over fewer rows may round an f32 logit differently
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["refs"], want["refs"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
