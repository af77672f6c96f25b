"""Cache locations (port of ``constants.py``): ``$VILMEDIC_TPU_CACHE``, else
``~/.cache/vilmedic_tpu`` (the JAX package's fallback without
``platformdirs``), and the zoo's model and data directories under it."""

import os

CACHE_DIR = os.environ.get("VILMEDIC_TPU_CACHE",
                           os.path.join(os.path.expanduser("~"), ".cache", "vilmedic_tpu"))
MODEL_ZOO_CACHE_DIR = os.path.join(CACHE_DIR, "zoo", "models")
DATA_ZOO_CACHE_DIR = os.path.join(CACHE_DIR, "zoo", "data")
