from .trainer import SolverType, Trainer

__all__ = ["SolverType", "Trainer"]
