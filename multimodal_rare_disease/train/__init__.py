from multimodal_rare_disease.train.trainer import Trainer, train_model  # noqa: F401
from multimodal_rare_disease.train.state import TrainState, create_train_state  # noqa: F401
from multimodal_rare_disease.train.schedules import make_schedule  # noqa: F401
