"""Metrics CLI: a hyps file, a refs file and a metric list -> the scores as
JSON (port of ``bin_tpu/vilmedic_metrics.py``; the same arguments and the
same printed JSON).

    python -m vilmedic_torch.bin.vilmedic_metrics --hyps h.txt --refs r.txt \\
        --metrics BLEU ROUGEL METEOR CIDERD

Blank lines are dropped from both files, which must then have as many lines.
Runs on the host: no card is needed.
"""

from __future__ import annotations

import argparse
import json

from ..scorers.scores import compute_scores
from ..utils import set_logger


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hyps", required=True)
    parser.add_argument("--refs", required=True)
    parser.add_argument("--metrics", nargs="+", required=True)
    args = parser.parse_args(argv)

    with open(args.hyps) as f:
        hyps = [line.strip() for line in f if line.strip() != ""]
    with open(args.refs) as f:
        refs = [line.strip() for line in f if line.strip() != ""]
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hyps vs {len(refs)} refs")

    logger = set_logger(None, "metrics")
    scores = compute_scores(metrics=args.metrics, refs=refs, hyps=hyps, split="cli",
                            seed="metrics", config=None, epoch=0, logger=logger, dump=False)
    print(json.dumps(scores, indent=4, default=str))
    return scores


if __name__ == "__main__":
    main()
