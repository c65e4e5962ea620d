"""Where a CTA of the bfloat16 ``dequant_mm`` and ``mlp_fused`` kernels
spends its cycles.

Builds ``csrc/dequant_mm.cu`` and ``csrc/mlp_fused.cu`` once more, into
``build/ddim_cold_torch/step_probe/``, with ``clock64()`` stamps added
around the phases of a pipeline step of ``csrc/gemm_wgmma.cuh`` and around
each output tile's epilogue; thread 0 of each consumer warpgroup adds its
cycles into device counters. Per case it prints one JSON line with the
average cycles a step spends in each phase and the cycles of an epilogue:

* ``wait_chunk``, ``barrier_direct``, ``fetch``: kBf16 and kS8 wait for their
  chunk's cp.async group, meet at the CTA barrier, and issue the copy of a
  later chunk;
* ``mma_issue``: the wgmma of the chunk;
* ``widen_store``, ``load_issue``: kWiden widens the next chunk from
  registers into the other stage (waiting for its loads) and issues the
  loads of the one after;
* ``mma_wait``, ``barrier_widen``: the wait for the wgmma, and kWiden's CTA
  barrier;
* ``store_tile_cycles``: one output tile's staging and store (dequant_mm's
  items, mlp_fused's fc2 tiles); ``gelu_tile_cycles``: one of mlp_fused's
  fc1 tiles through bias, rounding, GELU and into shared memory.

Run on a CUDA machine from the repository root::

    python3 -m ddim_cold_torch.tools.gemm_step_probe
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from ddim_cold_torch.ops import _build, quant

STEP = """    const int c = cur++;
    if constexpr (KIND != kWiden) {
      wait_chunk();                       // groups of chunks <= c + stages - 2 are committed
      wg::fence_proxy_async();
      __syncthreads();                    // chunk c visible; every wgmma of chunk c - 1 done
      fetch(c + stages - 1);              // into the stage of chunk c - 1
    }
    const uint64_t db = wg::desc<RB>(wg::smem_u32(ring + (c % stages) * CB));
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RB / 32; ++kk) mma(acc, da + 2 * kk, db + 2 * kk);
    wg::wgmma_commit();
    if constexpr (KIND == kWiden) {
      if (c + 1 < total) store(c + 1);   // its stage was read by chunk c - 1: done
      if (c + 2 < total) load(c + 2);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if constexpr (KIND == kWiden) {
      wg::fence_proxy_async();
      __syncthreads();                    // chunk c + 1 visible; stage c % 2 free
    }
"""
# the same step with a stamp after each phase (t0 .. t8)
TIMED_STEP = """    const int c = cur++;
    long long t[9];
    t[0] = clock64();
    t[1] = t[2] = t[3] = t[0];
    if constexpr (KIND != kWiden) {
      wait_chunk();
      t[1] = clock64();
      wg::fence_proxy_async();
      __syncthreads();
      t[2] = clock64();
      fetch(c + stages - 1);
      t[3] = clock64();
    }
    const uint64_t db = wg::desc<RB>(wg::smem_u32(ring + (c % stages) * CB));
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RB / 32; ++kk) mma(acc, da + 2 * kk, db + 2 * kk);
    wg::wgmma_commit();
    t[4] = t[5] = t[6] = clock64();
    if constexpr (KIND == kWiden) {
      if (c + 1 < total) store(c + 1);
      t[5] = clock64();
      if (c + 2 < total) load(c + 2);
      t[6] = clock64();
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    t[7] = clock64();
    if constexpr (KIND == kWiden) {
      wg::fence_proxy_async();
      __syncthreads();
    }
    t[8] = clock64();
    if (threadIdx.x % wg::kThreads == 0) {
      for (int i = 0; i < 8; ++i) atomicAdd(&g_probe[i], (unsigned long long)(t[i + 1] - t[i]));
      atomicAdd(&g_probe[8], 1ull);
    }
"""
COUNTERS = """__device__ unsigned long long g_probe[12];
extern "C" int step_probe_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
extern "C" int step_probe_zero() {
  unsigned long long z[12] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, z, sizeof(g_probe)));
}
"""
STORE = "  wg_sync();  // the stage is free for the next tile\n}"
TIMED_STORE = """  wg_sync();  // the stage is free for the next tile
  if (threadIdx.x % wg::kThreads == 0) {
    atomicAdd(&g_probe[9], (unsigned long long)(clock64() - e0));
    atomicAdd(&g_probe[10], 1ull);
  }
}"""
STORE_HEAD = "  constexpr int RS = stage_row_bytes<OT>();\n"
# mlp_fused's fc1 epilogue (bias, GELU, h into shared memory), timed per tile
GELU_HEAD = """      pipe.step(acc, wg::desc<RB>(wg::smem_u32(xs + t * gm::kRows * RB + g * 64 * RB)));
"""
GELU_TAIL = """          gm::bf16x2_bits(h0, h1);  // exact: h0, h1 are bf16 values
    }
"""
PHASES = ("wait_chunk", "barrier_direct", "fetch", "mma_issue", "widen_store", "load_issue",
          "mma_wait", "barrier_widen")


def _patch(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{what} moved: update the probe's anchor")
    return text.replace(old, new)


def _libraries() -> dict:
    out = _build.BUILD_DIR / "step_probe"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    header = out / "gemm_wgmma.cuh"
    text = header.read_text()
    text = _patch(text, "namespace gm {\n", COUNTERS + "namespace gm {\n", "namespace gm")
    text = _patch(text, STEP, TIMED_STEP, "Pipe::step")
    text = _patch(text, STORE_HEAD, STORE_HEAD + "  const long long e0 = clock64();\n",
                  "store_tile")
    text = _patch(text, STORE, TIMED_STORE, "store_tile's end")
    header.write_text(text)
    mlp = out / "mlp_fused.cu"
    text = _patch(mlp.read_text(), GELU_HEAD, GELU_HEAD + "    const long long e1 = clock64();\n",
                  "fc1's steps")
    text = _patch(text, GELU_TAIL, GELU_TAIL + """    if (threadIdx.x % wg::kThreads == 0) {
      atomicAdd(&g_probe[11], (unsigned long long)(clock64() - e1));
    }
""", "fc1's epilogue")
    mlp.write_text(text)
    libs = {}
    for name in ("dequant_mm", "mlp_fused"):
        so = out / f"{name}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(out / f"{name}.cu")],
                       check=True)
        lib = ctypes.CDLL(str(so))
        for symbol, argtypes in _build.SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.step_probe_read.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> None:
    libs = _libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    C = 256
    w, s = quant.quantize_weight(torch.randn((3 * C, C), generator=gen, device="cuda") * 0.05)
    b = torch.randn(3 * C, generator=gen, device="cuda")
    (w1, s1), (w2, s2) = (quant.quantize_weight(torch.randn((C, C), generator=gen, device="cuda")
                                                * 0.05) for _ in range(2))
    b1, b2 = (torch.randn(C, generator=gen, device="cuda") * 0.1 for _ in range(2))
    f1, f2 = (quant.dequantize_weight(wt, sc, torch.bfloat16) for wt, sc in ((w1, s1), (w2, s2)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in (128 * sms, 20008):
        x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
        cases = (("dequant_mm qkv", "dequant_mm", lambda: quant.dequant_mm(x, w, s, b, torch.bfloat16)),
                 ("mlp_fused float", "mlp_fused", lambda: quant.mlp_fused(x, f1, b1, f2, b2)),
                 ("mlp_fused w8a16", "mlp_fused", lambda: quant.mlp_fused(
                     x, w1, b1, w2, b2, scale1=s1, scale2=s2, mode="pallas")),
                 ("mlp_fused w8a8", "mlp_fused", lambda: quant.mlp_fused(
                     x, w1, b1, w2, b2, scale1=s1, scale2=s2, mode="w8a8")))
        for label, name, run in cases:
            _build._loaded[name] = libs[name]
            with torch.inference_mode():
                run()
                torch.cuda.synchronize()
                assert libs[name].step_probe_zero() == 0
                run()
                torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 12)()
            assert libs[name].step_probe_read(buf) == 0
            v = list(buf)
            steps, tiles = max(v[8], 1), max(v[10], 1)
            rec = {"case": label, "M": M, "cycles_per_step": {
                k: round(v[i] / steps) for i, k in enumerate(PHASES)},
                "store_tile_cycles": round(v[9] / tiles)}
            if name == "mlp_fused":  # as many fc1 tiles as fc2 tiles at hidden = out
                rec["gelu_tile_cycles"] = round(v[11] / tiles)
            print(json.dumps(rec), flush=True)
    _build._loaded.clear()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms}))


if __name__ == "__main__":
    main()
