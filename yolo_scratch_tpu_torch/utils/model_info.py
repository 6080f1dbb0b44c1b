"""Model summary: parameter count and FLOPs of one image's forward (port
of ``utils/model_info.py``).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``: 2 per
multiply-accumulate of the convolutions and matrix products, every tap of
every kernel counted, the zero padding's too. The JAX package's figure is
XLA's ``cost_analysis`` of the compiled forward, which counts a conv's
taps on the padding out (a 3x3 SAME conv on 8x8x16 -> 16: 247,808 against
294,912) and adds the elementwise work. So the port's count is above JAX's
by the padding's share, which falls with the image size. Measured on the
CPU, port / JAX: YOLO11n (crater, ch=1/nc=5) 1.1762 at 64 px, 1.0773 at
128, 1.0216 at 320, 1.0035 at 640; YOLOX-nano (ch=3/nc=80) 1.1685,
1.0718, 1.0175, 1.0000 (``tests/test_torch_utils.py`` holds the 64 px
ratios).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def count_params(params: Any) -> int:
    """Elements of a module's parameters, or of the tensors of a
    ``state_dict`` / list."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return int(sum(p.numel() for p in params))


@torch.no_grad()
def model_info(
    model: torch.nn.Module,
    img_size: int = 640,
    channels: Optional[int] = None,
    verbose: bool = False,
) -> Dict[str, float]:
    """Returns {'params', 'params_m', 'gflops'} for a one-image eval forward
    (NHWC input of ``channels``, default ``model.in_ch``, else 3), on the
    model's device; the model's train/eval mode is restored."""
    from torch.utils.flop_counter import FlopCounterMode

    ch = channels if channels is not None else getattr(model, "in_ch", 3)
    p = next(model.parameters())
    x = torch.zeros(1, img_size, img_size, ch, dtype=p.dtype, device=p.device)
    n_params = count_params(model)
    was_training = model.training
    model.eval()
    try:
        with FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(was_training)
    info = {"params": n_params, "params_m": n_params / 1e6,
            "gflops": counter.get_total_flops() / 1e9}
    if verbose:
        print(f"Model Summary: {n_params:,} parameters ({info['params_m']:.2f}M), "
              f"{info['gflops']:.1f} GFLOPs @ {img_size}x{img_size}")
    return info
