"""vaporetto_tpu_torch — the PyTorch/CUDA port of vaporetto_tpu.

Word segmentation with the reference Vaporetto's linear boundary model,
running on an NVIDIA GPU: compiled model tables live on the card, and
hand-written CUDA kernels score a whole batch per launch
(``csrc/boundary.cu``) and tag its tokens (``csrc/tags.cu``). The host
stages (model compiler, UTF-8 tensorizer, writers) are C++ built at first
use. Importing the package needs only torch and numpy; the predict and
evaluate CLIs are ``vaporetto_tpu_torch.cli.predict`` and
``vaporetto_tpu_torch.cli.evaluate``.
"""

from .analyzer import VaporettoAnalyzer
from .errors import InvalidArgumentError, InvalidModelError, VaporettoError
from .models.model import Model, NgramData, WordWeightRecord
from .predictor import Predictor
from .sentence import CharacterBoundary, CharacterType, Sentence, Token
from .serving import LeanServer

__version__ = "0.1.0"

__all__ = [
    "VaporettoError",
    "InvalidModelError",
    "InvalidArgumentError",
    "CharacterBoundary",
    "CharacterType",
    "Sentence",
    "Token",
    "Model",
    "NgramData",
    "WordWeightRecord",
    "Predictor",
    "LeanServer",
    "VaporettoAnalyzer",
    "__version__",
]


def __getattr__(name):
    # the trainer and the KyTea reader resolve at first use, as in the JAX
    # package, so that importing the package builds neither the trainer
    # nor its native parts
    if name in ("Trainer", "SolverType"):
        from .train import trainer

        return getattr(trainer, name)
    if name == "KyteaModel":
        from .models.kytea import KyteaModel

        return KyteaModel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
