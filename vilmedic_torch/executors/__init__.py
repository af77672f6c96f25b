"""Training executors of the port: optimizer factory, scheduler, trainer."""

from .scheduler import TrainingScheduler  # noqa: F401
from .train_state import create_optimizer, gated_update, set_learning_rate  # noqa: F401
from .trainor import Trainor  # noqa: F401
from .utils import create_model, create_training_scheduler  # noqa: F401
