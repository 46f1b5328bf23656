"""``python -m single_shot_detection_tpu_torch``: the port's ``main.py``
(see :mod:`single_shot_detection_tpu_torch.cli`)."""

from single_shot_detection_tpu_torch.cli import main

if __name__ == '__main__':
    main()
