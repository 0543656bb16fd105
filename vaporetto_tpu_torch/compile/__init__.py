from .merger import PositionalWeight, PositionalWeightWithTag, WeightMerger
from .artifact import deserialize_compiled, serialize_compiled
from .compiler import CompiledMatcher, CompiledModel, compile_model
from .convert import compiled_from_numpy

__all__ = ["PositionalWeight", "PositionalWeightWithTag", "WeightMerger",
           "CompiledMatcher", "CompiledModel", "compile_model",
           "compiled_from_numpy", "serialize_compiled",
           "deserialize_compiled"]
