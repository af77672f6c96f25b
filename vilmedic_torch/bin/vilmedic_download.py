"""Download CLI for the preprocessed datasets and the model zoo (port of
``bin_tpu/vilmedic_download.py``):

    python -m vilmedic_torch.bin.vilmedic_download --list
    python -m vilmedic_torch.bin.vilmedic_download NAME --source DIR_OR_ZIP
    python -m vilmedic_torch.bin.vilmedic_download NAME --url URL_OF_A_ZIP
    python -m vilmedic_torch.bin.vilmedic_download NAME

``--list`` prints the catalog with what the cache already holds. An entry
installs into the port's cache directories (``constants.py``:
``MODEL_ZOO_CACHE_DIR`` for the zoo's models, which ``AutoModel`` reads,
``DATA_ZOO_CACHE_DIR`` for datasets) from a local directory or ``.zip``
(``--source``), from a ``.zip`` at a direct URL (``--url``, ``urllib``), or
by name from the hub (``huggingface_hub``, imported in that branch only).
An entry already in the cache is left as it is.
"""

import argparse
import os

from ..constants import DATA_ZOO_CACHE_DIR, MODEL_ZOO_CACHE_DIR
from ..zoo.modeling_auto import MODEL_ZOO

DATA_ZOO = {
    "RRG/mimic-cxr": "MIMIC-CXR impression sections + image lists",
    "RRG/indiana": "Indiana (Open-I) reports + image lists",
    "RRG/padchest": "PadChest reports + image lists",
    "RRS/mimic-cxr": "MIMIC-CXR findings/impression pairs",
    "SELFSUP/mimic-cxr": "MIMIC-CXR report/image pairs for pretraining",
    "MVQA/imageclef": "ImageCLEF VQA-Med",
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("name", nargs="?", help="catalog entry to fetch")
    parser.add_argument("--list", action="store_true")
    parser.add_argument(
        "--source",
        help="install from a local directory or .zip archive instead of "
             "downloading (air-gapped deployments)",
    )
    parser.add_argument(
        "--url",
        help="download a .zip archive from a direct URL and install it "
             "(mirrors that are plain HTTP(S) servers)",
    )
    args = parser.parse_args(argv)

    if args.list or not args.name:
        print("Datasets:")
        for k, v in DATA_ZOO.items():
            cached = os.path.isdir(os.path.join(DATA_ZOO_CACHE_DIR, k))
            print(f"  [{'cached' if cached else '      '}] {k}: {v}")
        print("Models:")
        for k, v in MODEL_ZOO.items():
            cached = os.path.isdir(os.path.join(MODEL_ZOO_CACHE_DIR, k))
            print(f"  [{'cached' if cached else '      '}] {k}: {v}")
        return

    target_root = MODEL_ZOO_CACHE_DIR if args.name in MODEL_ZOO else DATA_ZOO_CACHE_DIR
    target = os.path.join(target_root, args.name)
    if os.path.isdir(target):
        print(f"{args.name} already cached at {target}")
        return
    if args.source:
        install_from_source(args.source, target)
        print(f"installed {args.name} to {target}")
        return
    if args.url:
        archive = download_url(args.url)
        try:
            install_from_source(archive, target)
        finally:
            os.unlink(archive)
        print(f"installed {args.name} to {target}")
        return
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(f"vilmedic/{args.name.replace('/', '-')}",
                          local_dir=target)
        print(f"downloaded to {target}")
    except Exception as e:
        raise SystemExit(
            f"Cannot download {args.name!r} (no network egress in this "
            f"environment?): {e}\nPlace the files manually under {target}."
        )


def download_url(url: str) -> str:
    """Stream a .zip from a direct URL into a temp file; returns its path."""
    import tempfile
    import urllib.request
    import zipfile

    fd, path = tempfile.mkstemp(suffix=".zip")
    try:
        with os.fdopen(fd, "wb") as out, urllib.request.urlopen(url) as resp:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
    except Exception as e:
        os.unlink(path)
        raise SystemExit(f"download failed for {url!r}: {e}")
    if not zipfile.is_zipfile(path):
        os.unlink(path)
        raise SystemExit(
            f"{url!r} did not return a .zip archive (an HTML error page from "
            f"the mirror?)"
        )
    return path


def install_from_source(source: str, target: str) -> None:
    """Install a catalog entry from a local directory or .zip archive."""
    import shutil
    import zipfile

    if not os.path.exists(source):
        raise SystemExit(f"--source {source!r} does not exist")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if os.path.isdir(source):
        shutil.copytree(source, target)
    elif zipfile.is_zipfile(source):
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(source) as z:
            z.extractall(target)
    else:
        raise SystemExit(f"--source must be a directory or .zip, got {source!r}")


if __name__ == "__main__":
    main()
