"""HF LLaMA-family checkpoint -> the port's
:class:`...blocks.llm.LlamaForCausalLM` (port of ``zoo/convert_llm.py``).

:func:`load_hf_llama` reads a local checkpoint directory: ``config.json``,
then the weights from one ``model.safetensors``, the shards an
``model.safetensors.index.json`` names (or, without an index, every
``*.safetensors`` file), else ``pytorch_model*.bin`` through
``torch.load(weights_only=True)``. Safetensors files are parsed by the
port's own reader (:func:`...scorers.bert_encoder.read_safetensors`).
HF's names map onto the port's by a rename: ``model.`` dropped and
``layers.{i}`` -> ``layers_{i}``; the linear weights keep their (out, in)
layout.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..blocks.llm.llama import LlamaConfig, LlamaForCausalLM, llama_config_from_hf

HF_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def hf_to_port_name(key: str) -> str:
    if key.startswith("model."):
        key = key[len("model."):]
    if key.startswith("layers."):
        _, i, rest = key.split(".", 2)
        key = f"layers_{i}.{rest}"
    return key


def _load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    from ..scorers.bert_encoder import read_safetensors

    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.isfile(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        paths = [os.path.join(model_dir, f) for f in files]
    else:
        paths = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    sd: Dict[str, torch.Tensor] = {}
    if paths:
        for path in paths:
            sd.update(read_safetensors(path))
        return sd
    bins = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    for path in bins:
        sd.update(torch.load(path, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin under {model_dir}")
    return sd


def load_hf_llama(model_dir: str, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """``(LlamaConfig, state dict under the port's names)`` of a local HF
    LLaMA checkpoint. The compute dtype is ``dtype``, else the config's
    ``torch_dtype``, else the weights' own."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    state = {hf_to_port_name(k): v for k, v in _load_state_dict(model_dir).items()
             if not k.endswith("rotary_emb.inv_freq")}
    if dtype is None:
        dtype = HF_DTYPES.get(hf_cfg.get("torch_dtype") or hf_cfg.get("dtype"))
    if dtype is None:
        dtype = state["embed_tokens.weight"].dtype
    return llama_config_from_hf(hf_cfg, dtype=dtype), state


def build_hf_llama(model_dir: str, dtype: Optional[torch.dtype] = None, device="cuda"
                   ) -> LlamaForCausalLM:
    """The checkpoint's model on ``device``, in its compute dtype."""
    cfg, state = load_hf_llama(model_dir, dtype)
    model = LlamaForCausalLM(cfg, device=device)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise ValueError(f"the checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(state[name].to(p.dtype))
    return model.eval()
