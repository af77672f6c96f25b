"""The port's reader of the JAX package's checkpoints
(``executors/checkpoint.py``: its own msgpack decoder, no ``msgpack`` or
``flax`` import) against ``flax.serialization.msgpack_restore``, and
``load_checkpoint`` on a JAX-written and on a port-written ``.ckpt``.

The trees hold f32, bf16 (read back as torch bfloat16 tensors: numpy has
no bfloat16; compared as uint16 bit patterns), int32 / int64 / uint8 /
bool leaves, numpy scalars, Python ints of every msgpack width, floats,
strings of every length class, None, booleans and lists; with
flax's chunk size lowered so that leaves go through its chunked form.
"""

import json

import flax.serialization as fs
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilmedic_torch.executors import checkpoint as tckpt
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax, vl_state_dict_from_jax


def _tree(rng):
    return {
        "params": {"dense": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                             "bias": rng.standard_normal(5).astype(np.float32)},
                   "embed": np.asarray(jnp.asarray(rng.standard_normal((40, 3)), jnp.bfloat16)),
                   "empty": np.zeros((0, 4), np.float32)},
        "ints": {"i32": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
                 "i64": np.arange(300, dtype=np.int64), "u8": np.arange(9, dtype=np.uint8),
                 "mask": np.array([True, False, True])},
        "scalars": [np.int32(7), np.float32(2.5), np.float64(-1.25), np.bool_(True)],
        "python": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1, -1, -32, -33,
                   -128, -129, -32768, -32769, -2 ** 31, -2 ** 63, 1.5, -0.0, None, True,
                   False],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "nested": {str(i): {"x": i} for i in range(20)},
        "config": json.dumps({"model": {"proto": "RRG"}}),
    }


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert np.shape(got) == np.shape(want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_msgpack_restore_matches_flax(monkeypatch, chunk):
    if chunk:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
    data = fs.msgpack_serialize(_tree(np.random.default_rng(0)))
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    want = fs.msgpack_restore(data)
    _same(tckpt.msgpack_restore(data), want)


def test_msgpack_rejects_truncated_and_trailing_data():
    data = fs.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        tckpt.msgpack_restore(data[:-2])
    with pytest.raises(ValueError, match="trailing"):
        tckpt.msgpack_restore(data + b"\x00")


@pytest.mark.parametrize("proto", ["RRG", "VisionLanguage"])
def test_jax_checkpoint_loads_as_the_port_payload(tmp_path, proto):
    """A JAX ``save_checkpoint`` file: the model through ``zoo/from_jax.py``
    by the config's proto, bf16 leaves widened exactly, the JSON strings as
    dicts, the optimizer state dropped; a port checkpoint beside it still
    loads through ``torch.load``."""
    from vilmedic_tpu.executors.checkpoint import save_checkpoint as jsave

    rng = np.random.default_rng(1)
    variables = {"params": {"dec": {"lm_head": {"kernel": rng.standard_normal((4, 6)).astype(
        np.float32), "bias": rng.standard_normal(6).astype(np.float32)}},
        "enc": {"ln": {"scale": np.asarray(jnp.asarray(rng.standard_normal(4), jnp.bfloat16)),
                       "bias": np.zeros(4, np.float32)}}}}
    if proto == "RRG":
        variables["batch_stats"] = {"enc": {"bn": {"mean": np.ones(3, np.float32),
                                                   "var": np.full(3, 2.0, np.float32)}}}
    config = {"model": {"proto": proto}, "seed": 3}
    path = tmp_path / "0.5_1_3.ckpt"
    jsave(str(path), {"model": variables, "opt_state": {"mu": np.zeros(2, np.float32)},
                      "training_scheduler": {"iteration_count": 12}, "config": config,
                      "__version__": "0.1"})
    got = tckpt.load_checkpoint(str(path))
    assert got["config"] == config and got["training_scheduler"] == {"iteration_count": 12}
    assert got["opt_state"] is None and got["__version__"] == "0.1"
    widened = json.loads(json.dumps(variables, default=lambda a: np.asarray(
        a, np.float32).tolist()))
    widened = {k: _arrays(v) for k, v in widened.items()}
    bridge = rrg_state_dict_from_jax if proto == "RRG" else vl_state_dict_from_jax
    want = bridge(widened)
    assert sorted(got["model"]) == sorted(want)
    for k in want:
        assert torch.equal(got["model"][k], want[k]), k
    assert "enc.bn.running_var" in got["model"] or proto != "RRG"
    tckpt.save_checkpoint(str(tmp_path / "port.ckpt"), got)
    again = tckpt.load_checkpoint(str(tmp_path / "port.ckpt"))
    assert again["config"] == config
    for k in want:
        assert torch.equal(again["model"][k], want[k]), k


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)
