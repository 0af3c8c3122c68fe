#!/usr/bin/env python3
"""How fast SMs pull device memory into shared memory by bulk
asynchronous copies (TMA, cp.async.bulk), the mechanism of the wide PCR
downsweep's ring (opty_tpu_torch/csrc/wide.cu).

    python3 scripts/bulk_copy_rate.py

Each of `blocks` blocks (one per SM: the ring takes most of an SM's
shared memory) streams its own `per_block` bytes through a ring of
`stages` chunks of `chunk` bytes, one mbarrier a chunk, refilled as soon
as the block's threads have touched the chunk: the downsweep's stream
without its arithmetic.  A chunk goes as one bulk copy, as eight, or
as 16-byte cp.async copies issued by a warp.  Timed with CUDA events,
L2-cold (the data is read once, well beyond the 50 MB L2) and L2-warm
(a 16 MB working set read again); prints the rate of one SM and of 16
and 132 SMs, with the card's name and power limit.  The kernel is
built by nvcc at run time into build/probes/ (gitignored).  Needs a
CUDA card.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / 'build' / 'probes'

SOURCE = r'''
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned su(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

// mode 0: one thread issues a chunk as one bulk copy; mode 1: warp 0
// issues it as 16-byte cp.async copies (.cg), each lane's tracked by an
// arrival on their completion; mode 2: eight lanes of warp 0 issue an
// eighth of it each as a bulk copy
__global__ void stream(const char* __restrict__ src, size_t per_block,
                       int chunk, int stages, int mode, unsigned* sink) {
  extern __shared__ __align__(16) unsigned char sm[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  unsigned char* buf = sm + ((stages * 8 + 15) / 16) * 16;
  const char* base = src + size_t(blockIdx.x) * per_block;
  const int n = int(per_block / size_t(chunk));
  const int lane = int(threadIdx.x) & 31;
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       su(bars + k)), "r"(mode == 1 ? 32 : 1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // called by warp 0
  auto issue = [&](int i) {
    unsigned long long* bar = bars + i % stages;
    unsigned char* dst = buf + size_t(i % stages) * chunk;
    const char* from = base + size_t(i) * chunk;
    if (mode == 1) {
      for (int off = lane * 16; off < chunk; off += 512)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         su(dst + off)), "l"(from + off) : "memory");
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   ::"r"(su(bar)) : "memory");
      return;
    }
    const int parts = mode == 2 ? 8 : 1;
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(su(bar)), "r"(unsigned(chunk)) : "memory");
    __syncwarp();
    if (lane < parts) {
      const int part = chunk / parts;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(su(dst + lane * part)),
          "l"(from + lane * part), "r"(unsigned(part)), "r"(su(bar))
          : "memory");
    }
  };
  if (threadIdx.x < 32)
    for (int i = 0; i < stages && i < n; ++i) issue(i);
  unsigned acc = 0;
  for (int i = 0; i < n; ++i) {
    unsigned done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(su(bars + i % stages)), "r"(unsigned(i / stages) & 1u)
          : "memory");
    } while (!done);
    acc += buf[size_t(i % stages) * chunk + threadIdx.x * 16];
    __syncthreads();
    if (threadIdx.x < 32 && i + stages < n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + stages);
    }
  }
  if (acc == 0x7fffffffu) sink[0] = acc;
}

extern "C" int launch_stream(const void* src, size_t per_block, int chunk,
                             int stages, int mode, int blocks, void* sink,
                             void* stream_) {
  const int smem = ((stages * 8 + 15) / 16) * 16 + stages * chunk;
  cudaError_t err = cudaFuncSetAttribute(
      stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  stream<<<blocks, 128, smem, static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const char*>(src), per_block, chunk, stages, mode,
      static_cast<unsigned*>(sink));
  return int(cudaGetLastError());
}
'''

CHUNK, STAGES = 32 * 1024, 6        # 192 KB of ring, as the downsweep's
MODES = {0: 'one bulk copy a chunk (TMA)',
         1: '16-byte cp.async by a warp',
         2: 'eight bulk copies a chunk'}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / 'bulk_copy_rate.cu', OUT / 'bulk_copy_rate.so'
    src.write_text(SOURCE)
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    subprocess.run([nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).launch_stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('bulk_copy_rate.py: needs a CUDA card')
    fn = build()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    sink = torch.zeros(1, dtype=torch.int32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def rate(mode, blocks, per_block, buf, reps):
        def run():
            err = fn(buf.data_ptr(), per_block, CHUNK, STAGES, mode, blocks,
                     sink.data_ptr(), stream)
            if err:
                raise RuntimeError('launch failed: cudaError {}'.format(err))
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times)[len(times) // 2]
        return ms, blocks * per_block / ms / 1e6    # GB/s

    print('rate of device memory into shared memory ({}; chunks of {} KB, '
          '{} in flight, 128 threads a block, one block an SM)'.format(
              smi, CHUNK // 1024, STAGES))
    for blocks in (1, 16, 132):
        # cold: 2 GB read once per timed run (256 MB for one block), so
        # that no run finds its data in the 50 MB L2
        per_block = 256 * 2 ** 20 if blocks == 1 else \
            (2 * 2 ** 30 // blocks) // CHUNK * CHUNK
        cold = torch.ones(blocks * per_block, dtype=torch.uint8,
                          device='cuda')
        wper = (16 * 2 ** 20 // blocks) // CHUNK * CHUNK
        warm = torch.ones(blocks * wper, dtype=torch.uint8, device='cuda')
        for mode in MODES:
            ms, gbs = rate(mode, blocks, per_block, cold, 3)
            wms, wgbs = rate(mode, blocks, wper, warm, 20)
            print('{}: {} blocks: cold {:.1f} GB/s in all, {:.1f} GB/s an '
                  'SM ({:.4f} ms for {:.1f} MB a block); warm {:.1f} GB/s '
                  'an SM ({:.4f} ms for {:.3f} MB a block)'.format(
                      MODES[mode], blocks, gbs, gbs / blocks, ms,
                      per_block / 2 ** 20, wgbs / blocks, wms,
                      wper / 2 ** 20))
        del cold, warm


if __name__ == '__main__':
    main()
