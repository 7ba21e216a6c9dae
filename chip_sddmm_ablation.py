#!/usr/bin/env python3
"""Where the time of the tensor-core block SDDMM goes, on one NVIDIA GPU (H100).

    python3 chip_sddmm_ablation.py

Builds variants of ``sparse_tpu_torch/kernels/csrc/bsr_tc.cu`` side by side
(one ``nvcc`` each, started together, into ``build/sddmm_ablation/``) and
times each one's float32 SDDMM (``st_bsr_sddmm_tc_f32``) on the wgrad of
``BlockSparseLinear(8192, 8192, 0.25)`` at batch 512 (1,042 blocks of 128 x
128), with the layer's MN-major operands (``grad_y.T``, ``x``) and K-major
copies of them:

- ``landed``: the source as it is;
- ``first``: the first design of the converters (warps 1-3, each 16-byte
  chunk gathered from four k-rows with 4-byte loads and split straight from
  shared memory; the producer a thread of its own);
- each with ``no_mma`` (the consumers wait and release but issue no
  ``wgmma``), ``no_convert`` (the converters wait and release but write
  nothing) or both: what the other half of the pipeline costs alone.

The ablated variants compute wrong results by design; the two whole ones
are held against the plain version (normalised error printed). Prints one
JSON line per variant (ms per launch from CUDA graphs of 20 launches, best
of two passes), then the card's ``name, power.limit``. Imports nothing of
JAX or sparse_tpu.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "sddmm_ablation"

# the first design's converters and producer/converter loop, as they stood
FIRST_CONVERTERS = r'''// one float32 raw stage split into a conv stage: for lhs, then rhs, its hi
// and lo tiles K-major and 128-byte swizzled (16-byte chunk c of row r at
// r * 128 + 16 (c ^ r % 8)). A K-major raw tile has that layout already. An
// MN-major one (k-row i of 128 floats at 512 i) is transposed: chunk q takes
// row r = q % 128 and chunk c = q / 128, reading one float of each of four
// k-rows.
template <bool kAmn, bool kBmn>
__device__ __forceinline__ void sddmm_split_stage(const unsigned char* raw, unsigned char* conv, int tid) {
  constexpr int kTile = SdLayout<float>::kTile;
  constexpr int kChunks = kTile / 16;
  for (int e = tid; e < 2 * kChunks; e += kConverters) {
    const int op = e / kChunks, q = e % kChunks;
    const unsigned char* src = raw + op * kTile;
    float4 x;
    int off;
    if (op == 0 ? kAmn : kBmn) {
      const int r = q % BM, c = q / BM;
      const float* f = reinterpret_cast<const float*>(src) + 4 * c * BM + r;
      x = make_float4(f[0], f[BM], f[2 * BM], f[3 * BM]);
      off = r * kRowBytes + ((c ^ (r & 7)) << 4);
    } else {
      off = q * 16;
      x = *reinterpret_cast<const float4*>(src + off);
    }
    float4 h, l;
    split4(x, h, l);
    *reinterpret_cast<float4*>(conv + op * kTile + off) = h;
    *reinterpret_cast<float4*>(conv + (2 + op) * kTile + off) = l;
  }
}

'''
FIRST_LOOP = r'''  const int wg = threadIdx.x / 128;
  uint32_t it = 0;  // stages so far, over all of this CTA's units
  if (wg == 0) {
    if (threadIdx.x == 0) {  // producer: TMA loads
      for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
        if (!unit(u)) continue;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const int s = (int)(it % SR);
          mbar_wait(&raw_empty[s], ((it / SR) & 1) ^ 1);
          unsigned char* st = raw + s * L::kRawBytes;
          mbar_expect_tx(&raw_full[s], L::kRawBytes);
          sddmm_load<T, kAmn>(st, &map_a, &raw_full[s], (int)row0, ks * L::kBke);
          sddmm_load<T, kBmn>(st + L::kTile, &map_b, &raw_full[s], (int)col0, ks * L::kBke);
        }
      }
    } else if constexpr (kSplit) {
      if (threadIdx.x >= 32) {  // converters: transpose and split
        const int tid = threadIdx.x - 32;
        for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
          if (!unit(u)) continue;
          for (int ks = 0; ks < n_k; ++ks, ++it) {
            const int sr = (int)(it % SR), sc = (int)(it % SC);
            mbar_wait(&raw_full[sr], (it / SR) & 1);
            mbar_wait(&conv_empty[sc], ((it / SC) & 1) ^ 1);
            sddmm_split_stage<kAmn, kBmn>(raw + sr * L::kRawBytes, conv + sc * L::kConvBytes, tid);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
            mbar_arrive(&raw_empty[sr]);
            mbar_arrive(&conv_full[sc]);
          }
        }
      }
    }
    return;
  }

'''


def source(name):
    from sparse_tpu_torch.kernels import _cuda

    s = Path(_cuda.SOURCES["bsr_tc"]).read_text()
    if name.startswith("first"):
        c0 = s.index("// the float32 converters of the SDDMM")
        c1 = s.index("// lhs element (m, k) and rhs element (k, n) as the TMA maps")
        s = s[:c0] + FIRST_CONVERTERS + s[c1:]
        l0 = s.index("  const int wg = threadIdx.x / 128;\n  uint32_t it = 0;")
        l1 = s.index("  // consumers: warpgroup c = wg - 1 owns rows [64 c, 64 c + 64) of the tile\n  const int c = wg - 1;")
        s = s[:l0] + FIRST_LOOP + s[l1:]
        s = _swap(s, "kSplit ? kSdConverters : 8", "kSplit ? kConverters : 8")
        s = _swap(s, "mbar_init(&conv_full[s], kSdConverters);", "mbar_init(&conv_full[s], kConverters);")
    if "no_mma" in name:
        s = _swap(s, "Mma<float>::run(d, desc_of(ac", "if (false) Mma<float>::run(d, desc_of(ac")
    if "no_convert" in name:
        if name.startswith("first"):
            s = _swap(s, "e < 2 * kChunks; e += kConverters", "e < 0 * kChunks; e += kConverters")
        else:
            s = _swap(s, "          sddmm_write_stage<kAmn, kBmn>(v, conv", "          if (false) sddmm_write_stage<kAmn, kBmn>(v, conv")
    return s


def _swap(s, old, new):
    if old not in s:
        raise ValueError(f"{old!r} is not in the source")
    return s.replace(old, new)


def build(name):
    from sparse_tpu_torch.kernels import _cuda

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(source(name))
    res = subprocess.run([_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-4000:]}")
    fn = ctypes.CDLL(str(so)).st_bsr_sddmm_tc_f32
    fn.argtypes = _cuda._SIGNATURES["bsr_tc"]["st_bsr_sddmm_tc_f32"]
    fn.restype = ctypes.c_int
    return name, fn


def main():
    if not torch.cuda.is_available():
        print("chip_sddmm_ablation: no CUDA device available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from sparse_tpu_torch import nn as tnn
    from sparse_tpu_torch.experiments.common import time_graph
    from sparse_tpu_torch.kernels import _cuda, bsr

    names = [f"{d}{a}" for d in ("landed", "first") for a in ("", "_no_mma", "_no_convert", "_no_mma_no_convert")]
    with ThreadPoolExecutor(len(names)) as pool:
        fns = dict(pool.map(build, names))

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    layer = tnn.BlockSparseLinear(8192, 8192, 0.25, generator=torch.Generator().manual_seed(0), device=dev)
    p = layer.params()
    gen = torch.Generator(device=dev).manual_seed(0)
    g = (torch.randn((512, 8192), device=dev, generator=gen) / 512**0.5).T
    x = torch.randn((512, 8192), device=dev, generator=gen)
    operands = {"mn_major": (g, x), "k_major": (g.contiguous(), x.T.contiguous().T)}
    want = bsr.bsr_sddmm_plain(p.block_rows, p.block_cols, g, x).double()
    out = torch.empty_like(p.blocks)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(fn, lhs, rhs):
        a, b = _cuda.sddmm_tc_major(lhs, 0), _cuda.sddmm_tc_major(rhs, 1)
        args = (p.block_rows.data_ptr(), p.block_cols.data_ptr(), out.shape[0], 128, 128, lhs.data_ptr(), lhs.shape[0],
                lhs.shape[1], a[1], int(a[0]), rhs.data_ptr(), rhs.shape[1], b[1], int(b[0]), out.data_ptr(), sms)

        def go():
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        return go

    rows = {name: {"variant": name} for name in names}
    for _ in range(2):  # the variants in turns, twice
        for name in names:
            for lay, (lhs, rhs) in operands.items():
                go = launch(fns[name], lhs, rhs)
                ms = time_graph(go, reps=20)
                row = rows[name]
                row[f"ms_{lay}"] = min(ms, row.get(f"ms_{lay}", ms))
                if "no_" not in name:
                    go()
                    err = float((out.double() - want).abs().max() / want.abs().max())
                    if not err <= 1e-5:
                        raise AssertionError(f"{name} {lay}: normalised error {err}")
                    row[f"err_{lay}"] = err
    for row in rows.values():
        print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
