"""Multi-device serving, evaluation and training: one process a device, over a (data x
model) mesh (``mesh.py``), with collectives built from all-reduce, and a
broadcast of the host's messages (``collectives.py``), a launcher that spawns the ranks
(``launch.py``) and the tensor-parallel RoI heads (``tp.py``)."""

from radnet_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, gather_train_state,
                                        make_mesh, make_param_shardings, shard_state_dict,
                                        shard_train_state)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "gather_train_state", "make_mesh",
           "make_param_shardings", "shard_state_dict", "shard_train_state"]
