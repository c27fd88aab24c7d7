// The window tiling of the Hopper banded RS-MMA kernels, shared by the
// forward (banded_attention.cu) and the backward (banded_attention_bwd.cu):
// query frame f of q_src [N, F, Tq, 3C] attends to the kv frames
// g = (f + shift + j) % F, j < lw, of kv_src [N, F, Tk, 3C].
//
// The window as row ranges, not lw frames: the kv frames f + shift + j are
// adjacent rows of kv_src but where the window wraps past frame F - 1, and
// the softmax does not depend on key order, so a query tile's key stream is
// one contiguous range of the clip's rows, or two at the wrap, read in
// 64-row TMA boxes that may cross frame boundaries (lw = F: the whole clip).
// The query frames that feed one kv frame, g - shift - j, are contiguous the
// same way.  Short frames share a tile: at T <= 32 a block's 64-row tile
// packs up to floor(64 / T) frames of one clip (fewer where the grid would
// leave SMs idle), and streams the union of their windows (lw + frames - 1
// frames); each pair of rows of such a tile is tested by index,
// (key frame - query frame - shift) mod F < lw.  A one-frame tile meets
// every row of its range, so only the rows past the range's end (the next
// frame's, the next clip's, or past the tensor, which TMA zero-fills) are
// masked.
//
// The kernels are persistent: a block walks the work items w = blockIdx.x,
// w + gridDim.x, ... (own tile x head), with its own tiles double-buffered,
// so that the next item's own tile and first streamed boxes arrive while it
// finishes the last one's products and stores.

#pragma once

#include <algorithm>

#include "attention_sm90.cuh"

namespace mmdiff {

// Depth of the streamed rings: as deep as two blocks per SM allow in shared
// memory beside two own tiles.
constexpr int stages_for(int dk) { return dk <= 64 ? 4 : 2; }
constexpr int kNoFrame = -(1 << 28);  // frame of a streamed row outside the range: meets nothing

// The window and the tiling of both sides.
struct BandedWindow {
  int n, frames, tq, tk, heads, dim, shift, window;
  int pack_q, pack_k;  // frames per 64-row tile of queries / keys
};

// Whether query frame fq meets key frame gk (frames of one clip): (gk - fq -
// shift) mod F < lw.  kNoFrame on either side meets nothing.
__device__ __forceinline__ bool in_window(const BandedWindow& a, int gk, int fq) {
  int d = gk - fq - a.shift;
  d += d < 0 ? a.frames : 0;
  d += d < 0 ? a.frames : 0;
  return (unsigned)d < (unsigned)a.window;
}

// 64-row tiles per clip of a [F, T] row space with `pack` frames per tile.
__host__ __device__ __forceinline__ int tiles_per_clip(int frames, int len, int pack) {
  return pack > 1 ? (frames + pack - 1) / pack : frames * ((len + sm90::kRows - 1) / sm90::kRows);
}

// Tile `index` (clip-major) of an [N, F, T] row space: clip n, first frame
// f0 and the frames it holds (more than one only when packed), first row r0
// within f0, its first row of the whole tensor and its real rows.  Row x of
// the tile is row (r0 + x) % T of frame f0 + (r0 + x) / T.
struct OwnTile {
  int n, f0, frames, r0, valid;
  long row0;
  __device__ OwnTile(int index, int nframes, int len, int pack) {
    const int per_clip = tiles_per_clip(nframes, len, pack);
    n = index / per_clip;
    const int t = index - n * per_clip;
    if (pack > 1) {
      f0 = t * pack;
      frames = min(pack, nframes - f0);
      r0 = 0;
      valid = frames * len;
    } else {
      const int tiles = (len + sm90::kRows - 1) / sm90::kRows;
      f0 = t / tiles;
      frames = 1;
      r0 = (t - f0 * tiles) * sm90::kRows;
      valid = min(sm90::kRows, len - r0);
    }
    row0 = ((long)n * nframes + f0) * len + r0;
  }
  // Frame within the clip of tile row x.
  __device__ int frame(int x, int len) const { return f0 + (r0 + x) / len; }
};

// The other side's rows that a tile meets: `span` frames from frame `first`,
// mod F, as at most two contiguous ranges of the clip's rows, [a0, a0 + alen)
// and [0, blen), streamed in boxes of 64 rows (na + nb of them).
struct Stream {
  int a0, alen, blen, na, nb;
  __device__ Stream(int first, int span, int nframes, int len) {
    const int fa = min(span, nframes - first);
    a0 = first * len;
    alen = fa * len;
    blen = (span - fa) * len;
    na = (alen + sm90::kRows - 1) / sm90::kRows;
    nb = (blen + sm90::kRows - 1) / sm90::kRows;
  }
  __device__ int boxes() const { return na + nb; }
  // Box j: the clip row of its first row, and the rows of its range from there.
  __device__ void box(int j, int& row, int& left) const {
    const int b = j < na ? j : j - na;
    row = (j < na ? a0 : 0) + b * sm90::kRows;
    left = (j < na ? alen : blen) - b * sm90::kRows;
  }
};

// A side's rows per frame, frames per tile, and tiles per head: the query
// side (own = queries: the forward and the backward's dq pass) or the key
// side (the backward's dk/dv pass).
__host__ __device__ __forceinline__ int own_len(const BandedWindow& a, bool q) {
  return q ? a.tq : a.tk;
}
__host__ __device__ __forceinline__ int own_pack(const BandedWindow& a, bool q) {
  return q ? a.pack_q : a.pack_k;
}
__host__ __device__ __forceinline__ int own_tiles(const BandedWindow& a, bool q) {
  return a.n * tiles_per_clip(a.frames, own_len(a, q), own_pack(a, q));
}

// Work items over one side's tiles: own tiles x heads, tile-major within a head.
__host__ __device__ __forceinline__ int work_items(const BandedWindow& a, bool q) {
  return own_tiles(a, q) * a.heads;
}

// Work item w: head h, its own 64-row tile, and the rows of the other side
// that the tile's frames meet -- the union of their windows, lw + frames - 1
// frames, at most F (then the whole clip from frame 0).
//   query tile (q): key frames from f0 + shift;
//   key tile:       query frames from g0 - shift - lw + 1 (the frames
//                   g - shift - j, j < lw, of its first kv frame g0 and the ones after).
struct Work {
  int h;
  OwnTile tile;
  Stream st;
  __device__ Work(const BandedWindow& a, int w, bool q)
      : h(w / own_tiles(a, q)),
        tile(w - h * own_tiles(a, q), a.frames, own_len(a, q), own_pack(a, q)),
        st(first(a, tile, q), min(a.window + tile.frames - 1, a.frames), a.frames,
           own_len(a, !q)) {}
  static __device__ int first(const BandedWindow& a, const OwnTile& t, bool q) {
    if (a.window + t.frames - 1 >= a.frames) return 0;
    return q ? (t.f0 + a.shift) % a.frames
             : ((t.f0 - a.shift - a.window + 1) % a.frames + a.frames) % a.frames;
  }
};

// Frames per 64-row tile of a [N, F, T] row space: at T <= 32 as many whole
// frames as fit (at most F), but fewer when the (N * tiles per clip, heads)
// grid would leave SMs without a block (one frame a tile at worst); 1 at
// T > 32.
static int frames_per_tile(int n, int frames, int len, int heads) {
  int pack = len <= sm90::kRows / 2 ? sm90::kRows / len : 1;
  if (pack > frames) pack = frames;
  while (pack > 1 && (long)n * tiles_per_clip(frames, len, pack) * heads < sm_count()) --pack;
  return pack;
}

// The window fields of a call (both sides' packing chosen for this card).
static BandedWindow banded_window(int n, int frames, int tq, int tk, int heads, int dim,
                                  int shift, int window) {
  BandedWindow w;
  w.n = n;
  w.frames = frames;
  w.tq = tq;
  w.tk = tk;
  w.heads = heads;
  w.dim = dim;
  w.shift = shift;
  w.window = window;
  w.pack_q = frames_per_tile(n, frames, tq, heads);
  w.pack_k = frames_per_tile(n, frames, tk, heads);
  return w;
}

// Launch one persistent kernel of one consumer warpgroup and the producer
// warp: as many blocks as fit on the card at once, at most one per work
// item.  Returns the launch's CUDA error.
template <typename Kernel, typename... Args>
static int launch_persistent(Kernel kernel, size_t smem, int items, cudaStream_t stream,
                             const Args&... args) {
  constexpr int kThreads90 = sm90::kWarpgroup + sm90::kProducerThreads;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads90, smem);
  if (err) return err;
  const int blocks = std::min(items, std::max(per_sm, 1) * sm_count());
  kernel<<<blocks, kThreads90, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace mmdiff
