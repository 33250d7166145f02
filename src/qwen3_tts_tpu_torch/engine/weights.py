"""Parameter trees between numpy and torch.

``params_from_numpy`` turns the JAX package's host parameter trees (numpy
leaves, as its ``init_talker``/``init_code_predictor``/``init_codec`` and
checkpoint importer return them) into this package's tensors, so one tree
feeds both packages. bfloat16 leaves (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) are carried bit for bit through a uint16 view.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def array_to_tensor(a, device) -> torch.Tensor:
    """One numpy leaf -> tensor on ``device`` (bf16 bit-exact)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_to(tree: Any, device) -> Any:
    """Move every leaf of a dict/list tree (tensors or numpy arrays) to
    ``device`` as tensors."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return array_to_tensor(tree, device)


def params_from_numpy(params, cp_params, codec_params, *, device):
    """(talker, code predictor, codec) numpy trees -> tensor trees on
    ``device``; structure, dtypes and values are kept."""
    return (tree_to(params, device), tree_to(cp_params, device),
            tree_to(codec_params, device))
