"""Device time of the bfloat16 ``dequant_mm`` and ``mlp_fused`` kernels
against their launch geometry.

Both kernels give each CTA 128 rows: ``mlp_fused`` one CTA a row tile
(157 CTAs at 20008 rows, two waves on 132 SMs), ``dequant_mm`` one
persistent CTA an SM walking (row tile, column tile) items. This probe
times each at one CTA's rows (128: the length of one CTA's chain), at one
full wave (128 rows an SM) and at the 200px/p4 serve shape (20008 rows),
and prints one JSON line per case with the device time in ms and the
PyTorch yardstick's (``F.linear``; ``F.linear``, ``F.gelu``, ``F.linear``)
at the same shape.

Times are CUDA-event medians of single calls, each queued behind about a
millisecond of device spin (``torch.cuda._sleep``), so the host has
enqueued the call's launches before the device reaches them: the events
time the device work, not the wrappers' launch overhead.

Run on a CUDA machine from the repository root::

    python3 -m ddim_cold_torch.tools.quant_kernel_probe
"""

from __future__ import annotations

import json
import statistics

import torch
import torch.nn.functional as F

from ddim_cold_torch.ops import quant

#: device spin ahead of each timed call, in clock cycles (about 1 ms)
SPIN_CYCLES = 2_000_000


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    C = 256
    codes = {n: quant.quantize_weight(torch.randn((rows, C), generator=gen, device="cuda") * 0.05)
             for n, rows in (("qkv", 3 * C), ("proj", C), ("fc1", C), ("fc2", C))}
    bias = {n: torch.randn(w.shape[0], generator=gen, device="cuda") * 0.1
            for n, (w, _) in codes.items()}
    deq = {n: quant.dequantize_weight(w, s, torch.bfloat16) for n, (w, s) in codes.items()}
    with torch.inference_mode():
        for M in (128, 128 * sms, 20008):
            x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
            for lin in ("qkv", "proj"):
                w, s = codes[lin]
                print(json.dumps({
                    "kernel": "dequant_mm", "M": M, "K": C, "N": w.shape[0],
                    "ms": device_ms(lambda: quant.dequant_mm(x, w, s, bias[lin], torch.bfloat16)),
                    "library_ms": device_ms(lambda: F.linear(x, deq[lin],
                                                             bias[lin].to(torch.bfloat16)))}),
                      flush=True)
            (w1, s1), (w2, s2) = codes["fc1"], codes["fc2"]
            b1, b2 = bias["fc1"], bias["fc2"]
            for mode in (None, "pallas", "w8a8"):
                if mode is None:
                    args, kw = (x, deq["fc1"], b1, deq["fc2"], b2), {}
                else:
                    args, kw = (x, w1, b1, w2, b2), dict(scale1=s1, scale2=s2, mode=mode)
                print(json.dumps({
                    "kernel": "mlp_fused", "mode": mode or "float", "M": M, "C": C,
                    "ms": device_ms(lambda: quant.mlp_fused(*args, **kw)),
                    "library_ms": device_ms(lambda: F.linear(F.gelu(F.linear(
                        x, deq["fc1"], b1.to(torch.bfloat16))), deq["fc2"],
                        b2.to(torch.bfloat16)))}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms}))


if __name__ == "__main__":
    main()
