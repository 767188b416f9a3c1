"""ray_tpu_torch.tune — hyperparameter search over runtime actors.

Reference surface: python/ray/tune (tuner.py:43, tune_config.py,
schedulers/async_hyperband.py, search/sample.py).

The port's copy of ``ray_tpu/tune/``: a ``Tuner`` over a
``TorchTrainer`` runs each trial's trainer in a trial actor.
"""

from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search import (BasicVariantSearcher, Categorical,
                                       Domain, Float, Integer, Searcher,
                                       TPESearcher, choice, grid_search,
                                       loguniform, randint, uniform)
from ray_tpu_torch.tune.tuner import (Result, ResultGrid, TrialStopped,
                                      TuneConfig, Tuner, get_checkpoint,
                                      report)

__all__ = [
    "ASHAScheduler", "FIFOScheduler", "PopulationBasedTraining",
    "BasicVariantSearcher", "Categorical", "Domain", "Float", "Integer",
    "Searcher", "TPESearcher", "choice", "grid_search", "loguniform",
    "randint", "uniform", "Result", "ResultGrid", "TrialStopped",
    "TuneConfig", "Tuner", "get_checkpoint", "report",
]
