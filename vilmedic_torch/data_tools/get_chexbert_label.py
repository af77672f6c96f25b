"""Label a report file with CheXbert's conditions (port of
``data_tools/get_chexbert_label.py``).

Usage::

    python -m vilmedic_torch.data_tools.get_chexbert_label DIR/train.report.tok [--device cpu]

reads ``split.report.tok`` (one report per line; the name must have that
shape), labels every report with :class:`~..scorers.chexbert.CheXbert` in
classification mode (batched, on the card unless ``--device`` names
another) and writes ``split.label.tok`` beside it: per line the positive
conditions joined by commas, ``No Finding`` where none is positive, the
lines joined by newlines without a last one. The weights and vocabulary
resolve as the scorer's do (``CHEXBERT_PTH`` / ``CHEXBERT_VOCAB`` or
``$VILMEDIC_WEIGHTS_DIR``'s ``chexbert/``).
"""

from __future__ import annotations

import argparse
import os

from ..scorers.chexbert import CONDITIONS, CheXbert


def compute_labels(report_file: str, device="cuda") -> str:
    """Write the label file of ``report_file``; returns its path."""
    dir_path = os.path.dirname(os.path.realpath(report_file))
    chunks = os.path.basename(report_file).split(".")
    if len(chunks) != 3:
        raise ValueError("input file name must be of type 'split.report.tok'")
    output_file = os.path.join(dir_path, f"{chunks[0]}.label.{chunks[2]}")
    print(f"The labels will be written in {output_file}")
    with open(report_file) as f:
        reports = [line.strip() for line in f]
    rows = CheXbert(device=device).get_labels(reports, mode="classification")
    lines = [",".join([CONDITIONS[i] for i, v in enumerate(row)
                       if isinstance(v, int) and v > 0] or ["No Finding"]) for row in rows]
    with open(output_file, "w") as f:
        f.write("\n".join(lines))
    return output_file


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("report_file", type=str)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv)
    return compute_labels(args.report_file, device=args.device)


if __name__ == "__main__":
    main()
