"""Process-group sharding: data-parallel front end, distributed BA.

PyTorch port of ``sfm_mvs_tpu/parallel/`` on ``torch.distributed``. Where
the JAX package shards an array over an axis of a device ``Mesh`` and
reduces with ``psum`` / ``all_gather`` inside ``shard_map``, here one rank
of a process group stands for one device of that axis: it holds one
contiguous block of the point axis (or its share of the frames or pairs),
and ``dist.all_reduce`` / ``dist.all_gather`` take the place of the
collectives. Functions take a ``mesh`` (``mesh.Mesh``, a thin wrapper over
an initialized process group) where the JAX functions take
``(mesh, axis)``.

The backend is the caller's choice, made once in
``dist.init_process_group``: NCCL on a machine with a card per rank, gloo
for ranks on the CPU or for several ranks sharing one card (NCCL refuses
two ranks on one device; gloo carries CUDA tensors through every
collective used here).
"""

from sfm_mvs_tpu_torch.parallel import mesh  # noqa: F401
