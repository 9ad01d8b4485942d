"""A sum in a fixed order, for plain versions whose kernels add their
terms one after another (the position gradients H12-H14): the same
chain of f32 additions gives the same bits on the CPU and the card."""
from typing import Sequence

import torch


def chain_sum(terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """terms[0] + terms[1] + ..., added in order from 0."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc
