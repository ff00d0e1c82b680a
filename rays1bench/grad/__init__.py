from rays1bench.grad.inverse import (
    image_loss, make_train_step, fit_scene, InverseConfig,
)
from rays1bench.grad.fd import fd_check

__all__ = ["image_loss", "make_train_step", "fit_scene", "InverseConfig",
           "fd_check"]
