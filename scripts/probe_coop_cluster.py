"""Ask the card whether one launch can be cooperative and a thread-block
cluster launch at once (the question behind the row kernels' K-split
meeting, csrc/fused_rows.cuh):

    python3 scripts/probe_coop_cluster.py

It compiles a stand-in of the row kernels' launch (256 threads a block, the
W4 / W8 tile ring's dynamic shared memory: 640 + 65,536 / 98,304 bytes) into
build/probe_coop_cluster/ with nvcc, and for clusters of 1, 2, 4 and 8 blocks
prints cudaOccupancyMaxActiveClusters (at that shared memory), the code that
cudaLaunchKernelEx returns with cudaLaunchAttributeCooperative beside
cudaLaunchAttributeClusterDimension on a grid of that many clusters, and
whether every block then passed a grid-wide barrier and a cluster barrier
(the barrier gives up after about a second, so a grid whose blocks are not
all resident reports a timeout instead of hanging). The card's name and
power limit come first.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

SRC = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void probe(unsigned* bar, int* out) {
  extern __shared__ int smem[];
  cg::cluster_group cl = cg::this_cluster();
  smem[threadIdx.x] = (int)threadIdx.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        if (clock64() - t0 > 2000000000LL) { atomicAdd(out + 1, 1); break; }
        __nanosleep(64);
      }
    }
  }
  __syncthreads();
  cl.sync();
  const int peer = *cl.map_shared_rank(smem + threadIdx.x, (cl.block_rank() + 1) % cl.num_blocks());
  cl.sync();                         // no block leaves while a peer reads its memory
  if (threadIdx.x == 0 && peer == 0) atomicAdd(out, 1);
}

extern "C" int probe_run(int cluster, int smem, int* max_clusters, int* passed, int* timeouts,
                         int* grid_out) {
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster);
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, probe, &cfg);
  *max_clusters = e == cudaSuccess ? n : -(int)e;
  if (e != cudaSuccess || n < 1) return (int)e;
  unsigned* bar;
  int* out;
  cudaMalloc(&bar, 8);
  cudaMalloc(&out, 8);
  cudaMemset(bar, 0, 8);
  cudaMemset(out, 0, 8);
  cfg.gridDim = dim3(n * cluster);
  cfg.numAttrs = 2;
  *grid_out = n * cluster;
  e = cudaLaunchKernelEx(&cfg, probe, bar, out);
  const cudaError_t s = cudaDeviceSynchronize();
  int h[2] = {-1, -1};
  cudaMemcpy(h, out, 8, cudaMemcpyDeviceToHost);
  *passed = h[0];
  *timeouts = h[1];
  cudaFree(bar);
  cudaFree(out);
  cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)s;
}
'''


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out = Path(__file__).resolve().parents[1] / "build" / "probe_coop_cluster"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SRC)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O2", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out / "probe.so"), str(out / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(out / "probe.so"))
    for smem in (640 + 65536, 640 + 98304):
        for cluster in (1, 2, 4, 8):
            vals = [ctypes.c_int(0) for _ in range(4)]
            code = lib.probe_run(cluster, smem, *[ctypes.byref(v) for v in vals])
            mc, passed, timeouts, grid = (v.value for v in vals)
            print(f"smem {smem} cluster {cluster}: max active clusters {mc}, grid {grid}, "
                  f"cooperative cluster launch code {code}, blocks through both barriers "
                  f"{passed} of {grid}, barrier timeouts {timeouts}", flush=True)


if __name__ == "__main__":
    main()
