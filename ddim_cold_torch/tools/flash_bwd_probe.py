"""Where the bfloat16 flash backward leaves its plain version at large logits.

Builds ``csrc/flash_bwd.cu`` once more with one line added to the bf16 dq
kernel: every (query row, key) pair's S = q·k and dP = dO·v, as the tensor
cores accumulated them, and the kernel's f32 P and dS (before dS is rounded
to bf16) are written to a ``(B·H, N, N, 4)`` buffer. Against the plain
version (f32 einsums) and float64, per case it prints one JSON line:

* the |Δ|/``grad_error_limit`` of dq and dk against the plain version, for
  the kernels and for a float64-exact version of the same rounding contract;
* the mean error of S and dP in ulps of the float64 value and the largest
  relative error of P, for the kernel and for the plain version;
* how many bf16 roundings of dS each side lands on a different value than
  float64 does, and the kernel than the plain version;
* at the dq element furthest past its limit: the row's four largest P, and
  for each key dS from each side, their bf16 roundings and k there.

Run on a CUDA machine from the repository root::

    python3 -m ddim_cold_torch.tools.flash_bwd_probe
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ddim_cold_torch.ops import _build
from ddim_cold_torch.ops import flash_attention as fa

#: (B, N, H, D, seed, gain): the two shapes of the card test at its seed,
#: more seeds at the small one, and the small one without the gain
CASES = [(2, 129, 2, 32, 6, 8.0), (2, 129, 2, 32, 7, 8.0), (2, 129, 2, 32, 8, 8.0),
         (2, 129, 2, 32, 9, 8.0), (2, 129, 2, 32, 6, 1.0), (2, 2501, 4, 64, 6, 8.0)]

_ANCHOR = "      s[i] = p * (dp[i] - dl[r]);\n"
_DUMP = """      if (g_dump != nullptr && q0 + wg::frag_row(i) < N && t * 64 + wg::frag_col(i) < N) {
        float* o = g_dump + ((static_cast<int64_t>(bh) * N + q0 + wg::frag_row(i)) * N
                             + t * 64 + wg::frag_col(i)) * 4;
        o[0] = s[i]; o[1] = dp[i]; o[2] = p; o[3] = p * (dp[i] - dl[r]);
      }
"""
_SETTER = """
__device__ float* g_dump = nullptr;
extern "C" int flash_bwd_probe_dump(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_dump, &p, sizeof(p)));
}
"""


def _library() -> ctypes.CDLL:
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    if src.count(_ANCHOR) != 1:
        raise RuntimeError("the dq kernel's dS line moved: update the probe's anchor")
    head, tail = src.split('#include "attn_wgmma.cuh"\n')
    src = head + '#include "attn_wgmma.cuh"\n' + _SETTER + tail.replace(_ANCHOR, _DUMP + _ANCHOR)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / "flash_bwd_probe.cu", _build.BUILD_DIR / "flash_bwd_probe.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.flash_bwd_dq.argtypes = _build.SIGNATURES["flash_bwd"]["flash_bwd_dq"]
    lib.flash_bwd_probe_dump.argtypes = [ctypes.c_void_p]
    return lib


def _dump(lib, q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """(B, H, N, N, 4): S, dP, P, dS of the bf16 dq kernel."""
    B, N, H, D = q.shape
    out = torch.zeros((B * H, N, N, 4), device=q.device)
    dq = torch.empty_like(q)
    assert lib.flash_bwd_probe_dump(out.data_ptr()) == 0
    strides = [s for t in (q, k, v, do, dq) for s in t.stride()[:3]]
    err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, N, H, D, 1,
                           *strides, scale, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and lib.flash_bwd_probe_dump(None) == 0, err
    return out.reshape(B, H, N, N, 4)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).double()


def _ulp(x: torch.Tensor) -> torch.Tensor:
    x = x.float().abs()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


def probe(lib, B, N, H, D, seed, gain) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = (torch.randn((B, N, 3, H, D), generator=gen, device="cuda") * gain).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    scale = D**-0.5
    o, lse = fa.flash_forward_reference(q, k, v, scale)
    do = torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    grad = fa.flash_backward(q, k, v, o, lse, do, scale)
    ref = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
    delta = fa.backward_delta(o, do)
    s_k, dp_k, p_k, ds_k = _dump(lib, q, k, v, do, lse, delta, scale).unbind(-1)

    ein = lambda a, b: torch.einsum("bnhd,bmhd->bhnm", a, b)  # noqa: E731
    q6, k6, v6, g6 = (t.double() for t in (q, k, v, do))
    lse4, d4 = lse.reshape(B, H, N, 1), delta.reshape(B, H, N, 1)
    s_6, dp_6 = ein(q6, k6), ein(g6, v6)
    p_6 = torch.exp(s_6 * scale - lse4.double())
    ds_6 = p_6 * (dp_6 - d4.double())
    s_f, dp_f = ein(q.float(), k.float()), ein(do.float(), v.float())
    p_f = torch.exp(s_f * scale - lse4)
    ds_f = p_f * (dp_f - d4)
    # the float64-exact version: P and dS rounded to f32, then dS to bf16
    ds_x = _bf16(ds_6.float())
    exact = (torch.einsum("bhnm,bmhd->bnhd", ds_x, k6) * scale,
             torch.einsum("bhnm,bnhd->bmhd", ds_x, q6) * scale)

    rec = {"B": B, "N": N, "H": H, "D": D, "seed": seed, "gain": gain,
           "max_abs_lse": lse.abs().max().item()}
    limits = [fa.grad_error_limit(ref[:, :, i]) for i in range(2)]
    for i, g in enumerate(("dq", "dk")):
        over = lambda x: ((x.float() - ref[:, :, i].float()).abs() / limits[i]).max().item()  # noqa: E731
        rec[g] = {"kernel_err_over_limit": over(grad[:, :, i]),
                  "float64_err_over_limit": over(exact[i].to(torch.bfloat16))}
    live = p_6 > 2.0**-30  # pairs whose P is not lost below f32's range
    for side, s, dp, p, ds in (("kernel", s_k, dp_k, p_k, ds_k), ("plain", s_f, dp_f, p_f, ds_f)):
        rec[side] = {
            "S_mean_err_ulps": ((s.double() - s_6).abs() / _ulp(s_6)).mean().item(),
            "dP_mean_err_ulps": ((dp.double() - dp_6).abs() / _ulp(dp_6)).mean().item(),
            "P_max_rel_err": ((p.double() - p_6).abs() / p_6)[live].max().item(),
            "dS_bf16_differs_from_float64": int((_bf16(ds) != _bf16(ds_6)).sum().item())}
    rec["dS_bf16_kernel_differs_from_plain"] = int((_bf16(ds_k) != _bf16(ds_f)).sum().item())

    r = (grad[:, :, 0].float() - ref[:, :, 0].float()).abs() / limits[0]
    b, n, h, d = (int(x) for x in torch.nonzero(r == r.max())[0])
    rec["worst_dq"] = {
        "at": [b, n, h, d], "kernel": grad[b, n, 0, h, d].item(), "plain": ref[b, n, 0, h, d].item(),
        "float64": exact[0][b, n, h, d].item(), "limit": limits[0][b, n, h, d].item(),
        "keys": [{"key": j, "P": p_6[b, h, n, j].item(), "k": k[b, j, h, d].item(),
                  "dS_float64": ds_6[b, h, n, j].item(), "dS_kernel": ds_k[b, h, n, j].item(),
                  "dS_plain": ds_f[b, h, n, j].item(),
                  "bf16_float64": ds_x[b, h, n, j].item(),
                  "bf16_kernel": _bf16(ds_k[b, h, n, j]).item(),
                  "bf16_plain": _bf16(ds_f[b, h, n, j]).item()}
                 for j in torch.argsort(p_6[b, h, n], descending=True)[:4].tolist()]}
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the probe runs the bf16 dq kernel: it needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _library()
    for case in CASES:
        print(json.dumps(probe(lib, *case)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
