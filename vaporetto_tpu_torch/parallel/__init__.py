"""Data parallelism: device meshes (:mod:`.mesh`), the corpus split over
processes (:mod:`.data`), the process group (:mod:`.distributed`), and
halo-overlap chunking of long lines (:mod:`.chunking`)."""

from .mesh import Mesh, make_mesh, shard_predict_fn, train_step_dryrun

__all__ = ["Mesh", "make_mesh", "shard_predict_fn", "train_step_dryrun"]
