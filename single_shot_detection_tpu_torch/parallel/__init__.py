"""Processes over ``torch.distributed``: the data axis and the model axis
(``parallel/mesh.py``), tensor sharding (``tensor.py``), GPipe
(``pipeline.py``) and spatial sharding (``spatial.py``)."""

from single_shot_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    ModelAxis, ZeroLayout, all_gather, all_gather_host, all_gather_rows,
    all_gather_slices, all_reduce_, all_reduce_grads, axis_size,
    broadcast_object, check_group, check_model_axis, data_count, data_index,
    destroy, initialize_distributed, model_axis, model_axis_off, model_mode,
    process_device, process_index, set_model_axis, tensor_state_sharding,
    zero_state_sharding)
