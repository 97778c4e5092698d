// K10 hs_ring_halo_exchange, and K11/K12 hs_ring_fused_sweeps: the ring
// halo exchange of the tiled solver and the whole Jacobi solve of a mesh of
// shards with the halo exchange inside the launch.
//
// Replaces these TPU kernels of opticalflowhs_tpu/kernels/rdma_halo.py:
//   * K10: _halo_kernel (line 49, called by ring_halo_exchange at line 104):
//     the periodic ring exchange of `halo` rows along y, (h, w) -> (h +
//     2 halo, w);
//   * K11: _fused_kernel (line 135, called by ring_fused_sweeps at line 304
//     and by its logic twin at line 371): all n Jacobi sweeps of a
//     row-decomposed shard in one launch, a sigma-row u/v halo exchanged
//     with both ring neighbours every s sweeps, the transfer overlapped with
//     the interior sweep, comm slots double-buffered by block parity;
//   * K12: _fused_kernel_2d (line 398, called at line 554): the same on a
//     (y, x) mesh, two-phase: row strips of the owned columns along y, then
//     full-height column strips along x that carry the fresh row halos, so
//     the corners land without diagonal transfers.
// On the TPU each chip runs one launch and pltpu.make_async_remote_copy
// moves the rows chip to chip with DMA semaphores. Here a device runs one
// launch for every shard it holds (several shards share a device on a
// virtual mesh), and a row moves by a plain store into the neighbour's comm
// slot: a global store on the same device, a peer store over NVLink on
// another (the wrapper enables peer access first). The sender then fences
// (__threadfence_system), meets its grid at a barrier, and release-stores a
// flag (st.release.sys) in the receiver's memory; the receiver acquire-loads
// it (ld.acquire.sys) until it reaches the block's epoch. Flags hold epochs
// (a per-call base plus the block index), so they never need a reset.
//
// K11/K12 design: one persistent cooperative grid a device (csrc/
// cooperative.cuh), as many blocks as can be resident: every shard that
// waits on another runs in the same launch, or the launch is refused. The
// state keeps only the owned th x tw pixels of each shard (two buffers, u/v
// ping-pong by block parity, as K6). Sweep block k: send the owned edge rows
// (and, on a 2-D mesh, the column strips) into the neighbours' slots of
// parity k % 2; then each block takes 64 x 64 owned tiles and stages the
// tile's window, grown by the block's sweeps, from the state, the row slots
// and the column slots, and runs the shared temporally blocked sweeps on
// chip (jacobi_tile.cuh) with the clamps at the true image edges from global
// coordinates. On a 1-D mesh a tile whose window reaches no halo row starts
// before the flags arrive (the reference's overlap of the transfer with the
// interior sweep); the others wait for their flags. The 2-D exchange runs
// serially before the sweeps, as the reference's does. A grid barrier ends
// the block. Parity double-buffering keeps a fast neighbour from overwriting
// a slot not yet read: its block k+2 send follows my block k+1 send, which
// follows my block k reads, through the flag waits (rdma_halo.py:177-185).
// Data written during the launch (state, slots) is read with __ldcg.
//
// Bound: a sweep block moves a K2 launch's 8 arrays of the owned pixels through
// device memory, plus the halo bytes over NVLink (450 GB/s each way) when
// the neighbours sit on other cards; a whole solve reads the four fields
// once and writes u and v once against 39 float32 operations a pixel a
// sweep.
//
// Exactness: the shared sweep body and clamps, so the owned pixels equal the plain
// version (kernels/ring.py) bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "jacobi_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// -- K10 ---------------------------------------------------------------------

struct HaloShard {
  const float* src;  // the shard, h x w
  float* own;        // its output, (h + 2 halo) x w
  float* up;         // the output of its upper ring neighbour
  float* dn;         // the output of its lower ring neighbour
};

__global__ void halo_kernel(const HaloShard* __restrict__ shards, int h, int w,
                            int halo) {
  const HaloShard sh = shards[blockIdx.y];
  const long long own = (long long)h * w, edge = (long long)halo * w;
  const long long total = own + 2 * edge;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < own) {
      sh.own[edge + i] = sh.src[i];
    } else if (i < own + edge) {  // my top rows: the upper neighbour's bottom halo
      const long long j = i - own;
      sh.up[edge + own + j] = sh.src[j];
    } else {  // my bottom rows: the lower neighbour's top halo
      const long long j = i - own - edge;
      sh.dn[j] = sh.src[own - edge + j];
    }
  }
}

// -- K11 / K12 ---------------------------------------------------------------

typedef unsigned long long u64;

struct RingShard {
  const float* u0;  // owned start, th x tw (null: zeros)
  const float* v0;
  float* ua;        // owned state, two u/v pairs
  float* va;
  float* ub;
  float* vb;
  const float* ex;  // fields of the extended shard, (th + 2 sy) x (tw + 2 sx)
  const float* ey;
  const float* et;
  const float* invd;
  float* rows;      // my row slots [parity][side: top, bottom][u, v][sy][tw]
  float* cols;      // my column slots [parity][side: left, right][u, v][eh][sx]
  u64* flags;       // my flags [phase: rows, columns][parity][side]
  float* nb_rows[2];  // the row slots of my upper and lower neighbours
  u64* nb_rflags[2];
  float* nb_cols[2];  // the column slots of my left and right neighbours
  u64* nb_cflags[2];
  int row0, col0;   // global (row, column) of owned pixel (0, 0)
};

struct RingGeom {
  int n_shards, th, tw, sy, sx, eh, ew;
  int n, s, img_h, img_w, tile;
  u64 epoch0;
};

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void wait_flag(const u64* p, u64 epoch) {
  while (ld_acquire_sys(p) < epoch) __nanosleep(64);
}

__device__ __forceinline__ size_t row_slot(const RingGeom& g, int parity,
                                           int side, int field) {
  return (size_t)((parity * 2 + side) * 2 + field) * g.sy * g.tw;
}

__device__ __forceinline__ size_t col_slot(const RingGeom& g, int parity,
                                           int side, int field) {
  return (size_t)((parity * 2 + side) * 2 + field) * g.eh * g.sx;
}

__device__ __forceinline__ int flag_index(int phase, int parity, int side) {
  return (phase * 2 + parity) * 2 + side;
}

// Owned pixel (r, c) of field f of a shard's state at block k.
__device__ __forceinline__ float state_at(const RingShard& sh, const RingGeom& g,
                                         int k, int f, int r, int c) {
  const size_t o = (size_t)r * g.tw + c;
  if (k == 0) {
    const float* s0 = f == 0 ? sh.u0 : sh.v0;
    return s0 != nullptr ? s0[o] : 0.0f;
  }
  // Block k reads what block k-1 wrote: pair A after an even block.
  const float* s = (k % 2 == 1) ? (f == 0 ? sh.ua : sh.va) : (f == 0 ? sh.ub : sh.vb);
  return __ldcg(s + o);
}

// Extended-shard pixel (ar, ac) of field f at block k of parity p: from the
// column slots, the row slots or the state.
__device__ __forceinline__ float extended_at(const RingShard& sh,
                                             const RingGeom& g, int k, int p,
                                             int f, int ar, int ac) {
  if (ac < g.sx) return __ldcg(sh.cols + col_slot(g, p, 0, f) + (size_t)ar * g.sx + ac);
  if (ac >= g.sx + g.tw)
    return __ldcg(sh.cols + col_slot(g, p, 1, f) + (size_t)ar * g.sx +
                  (ac - g.sx - g.tw));
  const int cc = ac - g.sx;
  if (ar < g.sy) return __ldcg(sh.rows + row_slot(g, p, 0, f) + (size_t)ar * g.tw + cc);
  if (ar >= g.sy + g.th)
    return __ldcg(sh.rows + row_slot(g, p, 1, f) +
                  (size_t)(ar - g.sy - g.th) * g.tw + cc);
  return state_at(sh, g, k, f, ar - g.sy, cc);
}

__global__ void __launch_bounds__(512, 1)
    ring_kernel(const RingShard* __restrict__ shards, RingGeom g) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const bool two_d = g.sx > 0;
  const int tiles_x = (g.tw + g.tile - 1) / g.tile;
  const int tiles_y = (g.th + g.tile - 1) / g.tile;
  const long long per_shard = (long long)tiles_x * tiles_y;
  const long long total = per_shard * g.n_shards;
  const int n_full = g.n / g.s, rem = g.n % g.s;
  const int n_blocks = n_full + (rem > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    const int ns = k < n_full ? g.s : rem;
    const int p = k % 2;
    const u64 epoch = g.epoch0 + k;
    // Phase R: my top owned rows into my upper neighbour's bottom slot, my
    // bottom owned rows into my lower neighbour's top slot.
    {
      const long long per = 2LL * 2 * g.sy * g.tw;
      for (long long i = gid; i < per * g.n_shards; i += gstride) {
        const RingShard& sh = shards[i / per];
        long long j = i % per;
        const int nb = (int)(j / (2LL * g.sy * g.tw));
        j %= 2LL * g.sy * g.tw;
        const int f = (int)(j / ((long long)g.sy * g.tw));
        j %= (long long)g.sy * g.tw;
        const int r = (int)(j / g.tw), c = (int)(j % g.tw);
        const int sr = nb == 0 ? r : g.th - g.sy + r;
        sh.nb_rows[nb][row_slot(g, p, 1 - nb, f) + (size_t)r * g.tw + c] =
            state_at(sh, g, k, f, sr, c);
      }
      __threadfence_system();
      grid.sync();
      for (long long i = gid; i < 2LL * g.n_shards; i += gstride) {
        const int nb = (int)(i % 2);
        st_release_sys(shards[i / 2].nb_rflags[nb] + flag_index(0, p, 1 - nb), epoch);
      }
    }
    if (two_d) {
      // Phase C, after both row halos have arrived: the full-height column
      // strips, row halos included, into the left and right neighbours'
      // column slots.
      for (long long i = gid; i < 2LL * g.n_shards; i += gstride)
        wait_flag(shards[i / 2].flags + flag_index(0, p, (int)(i % 2)), epoch);
      grid.sync();
      const long long per = 2LL * 2 * g.eh * g.sx;
      for (long long i = gid; i < per * g.n_shards; i += gstride) {
        const RingShard& sh = shards[i / per];
        long long j = i % per;
        const int nb = (int)(j / (2LL * g.eh * g.sx));
        j %= 2LL * g.eh * g.sx;
        const int f = (int)(j / ((long long)g.eh * g.sx));
        j %= (long long)g.eh * g.sx;
        const int r = (int)(j / g.sx), c = (int)(j % g.sx);
        const int ac = g.sx + (nb == 0 ? c : g.tw - g.sx + c);
        sh.nb_cols[nb][col_slot(g, p, 1 - nb, f) + (size_t)r * g.sx + c] =
            extended_at(sh, g, k, p, f, r, ac);
      }
      __threadfence_system();
      grid.sync();
      for (long long i = gid; i < 2LL * g.n_shards; i += gstride) {
        const int nb = (int)(i % 2);
        st_release_sys(shards[i / 2].nb_cflags[nb] + flag_index(1, p, 1 - nb), epoch);
      }
      for (long long i = gid; i < 2LL * g.n_shards; i += gstride)
        wait_flag(shards[i / 2].flags + flag_index(1, p, (int)(i % 2)), epoch);
      grid.sync();
    }
    // Sweeps: each block takes owned tiles of every shard.
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
      const RingShard& sh = shards[t / per_shard];
      const int tt = (int)(t % per_shard);
      const hs_tile::Window win = hs_tile::make_window_at(
          g.sy + (tt / tiles_x) * g.tile, g.sx + (tt % tiles_x) * g.tile, g.tile,
          g.tile, ns, g.eh, g.ew, sh.row0 - g.sy, sh.col0 - g.sx, g.img_h,
          g.img_w);
      if (!two_d) {
        // Only a window that reaches a halo row waits for that halo.
        if (threadIdx.x == 0) {
          if (win.r0 + win.wr_lo < g.sy)
            wait_flag(sh.flags + flag_index(0, p, 0), epoch);
          if (win.r0 + win.wr_hi > g.sy + g.th)
            wait_flag(sh.flags + flag_index(0, p, 1), epoch);
        }
        __syncthreads();
      }
      hs_tile::Buffers bf = hs_tile::carve(smem, win);
      hs_tile::stage(bf, win, sh.ex, sh.ey, sh.et, sh.invd, g.ew,
                     [&](int ar, int ac, long long, float& uu, float& vv) {
                       uu = extended_at(sh, g, k, p, 0, ar, ac);
                       vv = extended_at(sh, g, k, p, 1, ar, ac);
                     });
      __syncthreads();
      hs_tile::run_sweeps(bf, win, g.eh, g.ew, ns);
      // The owned part of the tile into the pair this block writes.
      float* du = k % 2 == 0 ? sh.ua : sh.ub;
      float* dv = k % 2 == 0 ? sh.va : sh.vb;
      const int r_lo = win.halo, r_hi = min(win.halo + g.tile, g.sy + g.th - win.r0);
      const int c_lo = win.halo, c_hi = min(win.halo + g.tile, g.sx + g.tw - win.c0);
      const int lw = c_hi - c_lo;
      const int cnt = (r_hi - r_lo) * lw;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        const int wr = r_lo + i / lw, wc = c_lo + i % lw;
        const size_t o = (size_t)(win.r0 + wr - g.sy) * g.tw + (win.c0 + wc - g.sx);
        du[o] = bf.su[wr * win.win_w + wc];
        dv[o] = bf.sv[wr * win.win_w + wc];
      }
      __syncthreads();  // the next tile reuses the shared memory
    }
    if (k + 1 < n_blocks) grid.sync();
  }
}

}  // namespace

// K10: one launch over the n local shards of `table` (n HaloShard records on
// the device); every pointer may lie on another device that this one can
// reach (hs_enable_peer).
extern "C" int hs_ring_halo_exchange(const void* table, int n, int h, int w,
                                     int halo, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || halo < 1 || halo > h)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)(h + 2 * halo) * w;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  halo_kernel<<<dim3(blocks, n), threads, 0, (cudaStream_t)stream>>>(
      (const HaloShard*)table, h, w, halo);
  return (int)cudaGetLastError();
}

// Let `device` store into `peer`'s memory: 0 when it can (already enabled
// included), cudaErrorPeerAccessUnsupported when the pair cannot.
extern "C" int hs_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it
    return 0;
  }
  return (int)err;
}

// Most K11/K12 blocks of `threads` threads that can be resident at once with
// a tile x tile window grown by s sweeps.
extern "C" int hs_ring_blocks(int s, int tile, int threads, int device,
                              int* blocks) {
  return (int)hs_coop::max_blocks(ring_kernel, hs_tile::smem_bytes(tile, tile, s),
                                  threads, device, blocks);
}

// K11 (sx = 0) and K12 (sx > 0): n sweeps of the n_shards RingShard records
// of `table`, on the device, in one cooperative launch of `grid` blocks.
extern "C" int hs_ring_fused_sweeps(const void* table, int n_shards, int th,
                                    int tw, int sy, int sx, int n, int s,
                                    int img_h, int img_w,
                                    unsigned long long epoch0, int tile,
                                    int threads, int grid, int device,
                                    void* stream) {
  if (n_shards < 1 || th < 1 || tw < 1 || sy < 1 || sy > th || sx < 0 ||
      sx > tw || n < 1 || s < 1 || s > sy || (sx > 0 && s > sx) || tile < 1 ||
      grid < 1 || epoch0 < 1)
    return (int)cudaErrorInvalidValue;
  RingGeom g;
  g.n_shards = n_shards;
  g.th = th;
  g.tw = tw;
  g.sy = sy;
  g.sx = sx;
  g.eh = th + 2 * sy;
  g.ew = tw + 2 * sx;
  g.n = n;
  g.s = s;
  g.img_h = img_h;
  g.img_w = img_w;
  g.tile = tile;
  g.epoch0 = epoch0;
  const RingShard* shards = (const RingShard*)table;
  void* args[] = {&shards, &g};
  return (int)hs_coop::launch(ring_kernel, grid, threads,
                              hs_tile::smem_bytes(tile, tile, s), args, device,
                              stream);
}
