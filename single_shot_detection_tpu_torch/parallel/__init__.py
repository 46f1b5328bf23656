"""Data parallelism over processes (``parallel/mesh.py``)."""

from single_shot_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    ZeroLayout, all_gather, all_gather_host, all_gather_rows,
    all_gather_slices, all_reduce_, all_reduce_grads, broadcast_object,
    check_group, destroy, initialize_distributed, process_device,
    process_index, zero_state_sharding)
