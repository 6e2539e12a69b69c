"""The mesh engine's public names in one place (port of
``fedml_tpu.simulation.mesh.mesh_simulator``): the layout
(``layout.py``), the collectives (``collectives.py``) and the round and
driver (``engine.py``)."""

from ..staging import AsyncCohortStager  # noqa: F401
from .engine import (MeshBlockRoundFn, MeshFedAvgAPI,  # noqa: F401
                     make_mesh_round_core)
from .layout import MeshLayout  # noqa: F401
