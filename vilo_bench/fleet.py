"""The fleet traffic generator: window problems and their perturbed initial
states, made from the run's seed and the cell's traffic file.

It follows `cerberus_tpu_torch/parallel/fleet.py::build_fleet`: a few
distinct window problems (`scene.py`), each replicated over the batch,
every copy started from the true state with Monte-Carlo perturbations of
position, speed and calf length and with zero IMU biases. Each timed batch
draws fresh perturbations on the card from (seed, batch index), so no
batch repeats another."""

from __future__ import annotations

import torch

from vilo_bench.frozen import factors as fac

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def batch_seed(seed: int, k: int) -> int:
    """The generator seed of batch k of a run (k = -1: the warm-up batch)."""
    return (seed * 1_000_003 + k + 2) % (2 ** 63)


def replicate(tree, batch: int, n_segments: int):
    """Every leaf's segment axis repeated to `batch` rows, segment-major:
    rows [s * batch // n, (s + 1) * batch // n) are copies of segment s."""
    idx = torch.arange(batch) * n_segments // batch
    return fac.map_tensors(lambda x: x[idx.to(x.device)].contiguous(), tree)


def perturbed(truths: fac.WindowState, traffic: dict, seed: int, k: int):
    """Batch k's initial states: truth plus Gaussian noise of the traffic's
    sigmas on p, v and rho, drawn on the truths' device, and zero biases."""
    g = torch.Generator(device=truths.p.device)
    g.manual_seed(batch_seed(seed, k))
    B = truths.p.shape[0]
    noise = torch.randn((B, truths.p.shape[1], 10), generator=g,
                        dtype=truths.p.dtype, device=truths.p.device)
    pt = traffic["perturb"]
    return truths._replace(
        p=truths.p + pt["p_sigma"] * noise[..., 0:3],
        v=truths.v + pt["v_sigma"] * noise[..., 3:6],
        rho=truths.rho + pt["rho_sigma"] * noise[..., 6:10],
        ba=torch.zeros_like(truths.ba), bg=torch.zeros_like(truths.bg))


def sample_rows(batch: int, per_batch: int, seed: int, k: int) -> torch.Tensor:
    """The rows of batch k whose answers are checked, drawn from the seed."""
    g = torch.Generator()
    g.manual_seed(batch_seed(seed, k) ^ 0x5EED)
    return torch.randperm(batch, generator=g)[:per_batch].sort().values
