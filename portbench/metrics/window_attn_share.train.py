"""Share of the traced window in which the window attention's kernels ran
(``torch.profiler``'s device trace), in percent: the kernels whose names hold
one of :data:`KERNELS`, the fused backends of ``F.scaled_dot_product_attention``
as the H100 shows them and any later kernel of the port named ``window_attn``."""

#: Substrings of the kernels that compute the window attention: PyTorch's
#: memory-efficient backend (``fmha_cutlassF_*`` forward, ``fmha_cutlassB_*``
#: backward), its flash and cuDNN backends, and the port's own.
KERNELS = ("fmha_cutlass", "flash_fwd", "flash_bwd", "cudnn_generated_fort_native_sdpa",
           "window_attn")


def attention_seconds(run):
    """Device seconds of the attention kernels in the traced window, or None."""
    t = run.trace_data
    if t is None or t.window_s <= 0:
        return None
    busy = t.device_time(lambda name, cat: cat == "kernel" and any(k in name for k in KERNELS))
    return busy if busy > 0 else None


def read(run):
    busy = attention_seconds(run)
    return None if busy is None else 100.0 * busy / run.trace_data.window_s
