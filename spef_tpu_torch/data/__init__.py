from spef_tpu_torch.data.camera import (  # noqa: F401
    DSPEED_CAMERA,
    SPEED_CAMERA,
    SPEED_PLUS_CAMERA,
    Camera,
    load_camera,
)
