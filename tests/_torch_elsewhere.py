"""A tensor on a device that is neither the CPU, CUDA nor ``meta`` (the
dry-run's trace), for the kernel wrappers' no-fallback rule: such a tensor
must raise, never reach the plain version. torch here has no such
device, so the tensor only reports one."""
import torch


class _Elsewhere(torch.Tensor):
    @property
    def device(self):
        return torch.device("xpu")


def elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_Elsewhere)
