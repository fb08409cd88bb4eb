"""Losses, the port of `hetu_tpu/ops/losses.py`
(`softmax_cross_entropy_sparse`, the LM loss)."""
import torch


def softmax_cross_entropy_sparse(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_index: int = -100,
                                 reduction: str = "mean") -> torch.Tensor:
    """Sparse-label cross entropy in fp32; positions labelled
    `ignore_index` contribute nothing.  "mean" divides by the count of
    the others (at least 1), "sum" adds them, "none" keeps the
    per-position losses."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ignored = labels == ignore_index
    safe = torch.where(ignored, torch.zeros_like(labels), labels)
    target = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    mask = (~ignored).float()
    loss = (logz - target) * mask
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
