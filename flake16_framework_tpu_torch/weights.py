"""Fitted forests carried across from the JAX package: a JAX ``Forest``
whose fields are given as numpy arrays becomes the port's ``Forest`` on a
device, so the port can predict with the reference's trees."""

import numpy as np
import torch

from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops.trees import Forest

_DTYPES = {"feature": torch.int32, "threshold": torch.float32,
           "left": torch.int32, "right": torch.int32,
           "value": torch.float32, "n_nodes": torch.int32}


def forest_from_numpy(forest, device=None):
    """``forest``: any object with the Forest field attributes (a JAX
    ``Forest`` after ``np.asarray`` of each field, or a dict-like
    namespace), one ensemble with a leading tree axis."""
    dev = resolve(device)
    fields = {k: torch.as_tensor(np.array(getattr(forest, k)), dtype=dt,
                                 device=dev)
              for k, dt in _DTYPES.items()}
    return Forest(**fields, max_depth=int(np.max(forest.max_depth)))
