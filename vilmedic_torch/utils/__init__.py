from .logger import add_logging_level, get_logger_directory, set_logger  # noqa: F401
from .seed import extract_seed_from_ckpt, get_seed  # noqa: F401
