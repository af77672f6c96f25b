"""Convert a reference ViLMedic RRG ``.pth`` checkpoint into a port
``.ckpt`` (port of ``bin_tpu/convert_checkpoint.py``).

Usage::

    python -m vilmedic_torch.bin.convert_checkpoint model.pth out_dir/ \\
        --num-layers 1 --backbone densenet169

reads the torch checkpoint (``{"model": state_dict, "config": ...}``),
drops DataParallel ``module.`` prefixes, maps the BertGeneration decoder
and the torchvision tower onto the port's names
(``zoo.convert.convert_reference_rrg``) and writes
``{tag}_{epoch}_{seed}.ckpt`` through ``executors.checkpoint.
save_checkpoint``, which ``zoo.AutoModel.from_pretrained`` loads (with the
run's ``vocab.tgt`` placed in the same directory). A ``config`` that is not
a dict (the reference's OmegaConf object) is converted by ``omegaconf``
where it is installed, else written as ``{}``, as the JAX package's CLI
does.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("pth")
    parser.add_argument("out_dir")
    parser.add_argument("--num-layers", type=int, required=True,
                        help="decoder num_hidden_layers")
    parser.add_argument("--backbone", default="densenet169")
    parser.add_argument("--tag", default="0.0")
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--seed", default="000000")
    args = parser.parse_args(argv)

    import torch

    from ..executors.checkpoint import save_checkpoint
    from ..zoo.convert import convert_reference_rrg

    state = torch.load(args.pth, map_location="cpu", weights_only=False)
    model_state = {k.replace("module.", ""): v for k, v in state["model"].items()}
    model = convert_reference_rrg(model_state, num_layers=args.num_layers,
                                  backbone=args.backbone)
    os.makedirs(args.out_dir, exist_ok=True)
    config = state.get("config")
    if config is not None and not isinstance(config, dict):
        try:
            from omegaconf import OmegaConf

            config = OmegaConf.to_container(config)
        except Exception:
            config = {}
    path = os.path.join(args.out_dir, f"{args.tag}_{args.epoch}_{args.seed}.ckpt")
    save_checkpoint(path, {"model": model, "opt_state": None, "training_scheduler": {},
                           "config": config or {},
                           "__version__": state.get("__version__", "reference")})
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
