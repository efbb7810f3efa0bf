// Fused fitted-HHO local assembly on quadrilateral cells, for Hopper (sm_90a).
//
// Replaces the TPU kernel proton_tpu/methods/pallas_assembly.py:fused_local_operator
// (pl.pallas_call at :340, kernel body _make_kernel). For every quad cell it computes
// lc = a_T + s_T: the gradient-reconstruction form (tensor Gauss-Legendre quadrature on
// the bilinear map, scaled-monomial gradients, reconstruction stiffness K, face couplings
// gr, a Cholesky solve, a_T = gr^T K^-1 gr) plus the naive face stabilization
// s_T = sum_F (R_F^T M_F R_F) / |T|. The plain PyTorch version of the same function is
// proton_tpu_torch/methods/fused_assembly.py:fitted_local_operator_plain.
//
// Bound. Per cell the kernel reads 40 values and writes d^2 (d = 14 at k=1, 22 at k=2).
// On an H100 SXM (3.35 TB/s, 34 TFLOP/s float64 outside the tensor cores) at 1024^2 cells
// in float64: k=1 moves 1.98 GB, 0.59 ms, against ~6.3 kFLOP per cell, 0.19 ms; k=2 moves
// 4.40 GB, 1.31 ms, against ~24 kFLOP per cell, 0.75 ms. The bytes bound it at every
// degree, and 196 of 236 values per cell at k=1 (484 of 524 at k=2) are output, so the
// kernel has to stream stores at close to the memory rate. chip_smoke.py recomputes the
// bound for the card it runs on.
//
// Design. A block owns a tile of 32 cells (lane = cell) and has WARPS warps; it is
// persistent and walks over the tiles blockIdx.x, blockIdx.x + gridDim.x, ... The per-cell
// working set lives in dynamic shared memory as rows of 32 values, [row][cell]: a warp's
// access to a row is 32 consecutive values, with no bank conflict, and every row index a
// warp uses is the same on all its lanes. Register arrays are only indexed by constants
// (every loop over them is unrolled over compile-time sizes), so nothing lives in local
// memory. Per tile, three phases separated by __syncthreads():
//   P1  ten jobs over the warps, each on the tile's inputs in shared memory: (a) the cell
//       moments mu over the cell rule, then K (from mu, in registers) factored K = L L^T row
//       by row into shared memory, inverse diagonal kept; (b) the boundary moments over the
//       four face rules, x then y, folded at once into the cell columns of gr as -corr;
//       (c) per face F, the face mass M_F and trace T_F over the face rule, M_F = L_F L_F^T
//       unrolled (fbs <= 3), and Z_F = [L_F^-1 T_F, -L_F^T] / sqrt|T|; (d) per face F, its
//       columns of gr (hho.hpp:55-148). Jobs are dealt in snake order, so the two long ones
//       (a, b) share their warps with (d) at most, and the serial Cholesky overlaps the rest;
//   P2  the d columns of gr over the warps: a cell column gets its stiffness part from mu,
//       then every column is solved, Y = L^-1 gr, in place;
//   P3  lc = Y^T Y + sum_F Z_F^T Z_F. The stabilization is the Gram product of the Z_F, so
//       no d x d block is ever held: each (i, j), i <= j, is summed once from shared memory,
//       with the sparsity of Z_F (a face's columns meet only its own face and the cell),
//       and stored to rows i*d+j and j*d+i. A warp's store is 32 consecutive values of one
//       output row (256 B in float64); rows are dealt to warps in snake order. The inputs
//       are dead by now, so the next tile's are requested (cp.async) into their rows first,
//       and land while this tile is stored.
// Shared memory per tile: 40 + tri(2k+1) + tri(NR) + NR*d + 4 tri(fbs) + 4 fbs*cbs rows of
// 32 values (NR = rbs - 1): 48,896 B at k=1 and 113,152 B at k=2 in float64, so four k=1
// or two k=2 tiles are resident on an SM (the boundary moments are folded into gr in P1
// rather than kept, which is what lets two k=2 tiles fit). The launch geometry (cells per
// tile, warps, shared-memory bytes) is mirrored in fused_assembly.py's LAUNCH_GEOMETRY;
// the launcher refuses a geometry that differs from the compiled one (-3).
//
// Why this answers the bound: with one thread per cell the whole working set sits in one
// thread, spills to local memory (1.5 kB of stack at k=1, 6 kB at k=2 on sm_90a) and leaves
// 8 warps per SM to issue stores behind a 6-24 kFLOP serial chain. Here
// the working set sits in shared memory, the quadrature work is split over warps, the
// serial Cholesky overlaps the face work, a tile's input loads are in flight while the
// previous tile is stored, and every warp of every resident block stores: while one block
// computes, the other resident blocks' stores keep the memory busy. What is left between
// the kernel and its bound is P1-P2, which a block spends without storing, and the store
// stream itself, whose 256 B pieces land on d^2 rows far apart in memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;    // cells per block; lane = cell
constexpr int kInputs = 40;  // packed input values per cell

// Gauss-Legendre rules on [-1, 1] with n = 1..4 nodes, as numpy's leggauss gives them
// (the port's gauss_legendre); the launcher checks the caller's tables against them.
__host__ __device__ constexpr double gl_node(int n, int q) {
  return n == 1   ? 0.0
         : n == 2 ? (q == 0 ? -0.5773502691896257 : 0.5773502691896257)
         : n == 3 ? (q == 0 ? -0.7745966692414834 : q == 1 ? 0.0 : 0.7745966692414834)
                  : (q == 0   ? -0.8611363115940526
                     : q == 1 ? -0.33998104358485626
                     : q == 2 ? 0.33998104358485626
                              : 0.8611363115940526);
}

__host__ __device__ constexpr double gl_weight(int n, int q) {
  return n == 1   ? 2.0
         : n == 2 ? 1.0
         : n == 3 ? (q == 1 ? 0.8888888888888888 : 0.5555555555555557)
                  : (q == 1 || q == 2 ? 0.6521451548625462 : 0.3478548451374537);
}

// Monomial m = x^a y^b in the total-degree order of _exponent_tables (bases.hpp:114-127):
// m = tri(a + b) + b, for total degree <= 5.
__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }
__host__ __device__ constexpr int total_degree(int m) {
  return m >= 15 ? 5 : m >= 10 ? 4 : m >= 6 ? 3 : m >= 3 ? 2 : m >= 1 ? 1 : 0;
}
__host__ __device__ constexpr int exp_y(int m) { return m - tri(total_degree(m)); }
__host__ __device__ constexpr int exp_x(int m) { return total_degree(m) - exp_y(m); }
__host__ __device__ constexpr int mono_index(int a, int b) { return tri(a + b) + b; }

// Per degree pair: warps per block, and the blocks per SM the register budget is cut for
// (65,536 / (32 WARPS MIN_BLOCKS) registers a thread: 73 at k=0, 102 at k=1, 128 at k=2),
// chosen on an H100 so that no instantiation spills and shared memory is the limit.
__host__ __device__ constexpr int warps_for(int cd, int fd) {
  return fd == 0 ? 4 : fd == 1 ? 5 : 8;
}
__host__ __device__ constexpr int min_blocks_for(int cd, int fd) {
  return fd == 0 ? 7 : fd == 1 ? 4 : 2;
}

template <int CELDEG, int FACDEG>
struct Shape {
  static constexpr int RECDEG = FACDEG + 1;
  static constexpr int RBS = tri(RECDEG + 1);
  static constexpr int CBS = tri(CELDEG + 1);
  static constexpr int FBS = FACDEG + 1;
  static constexpr int D = CBS + 4 * FBS;
  static constexpr int NR = RBS - 1;
  static constexpr int NQC = RECDEG + 1;  // GL nodes per axis, degree 2*RECDEG
  static constexpr int NQF = FACDEG + 1;  // GL nodes of degree 2*FACDEG
  static constexpr int NFM = tri(FBS);
  static constexpr int NMU = tri(2 * RECDEG - 1);  // cell moments, degree <= 2 RECDEG - 2
  static constexpr int DB = RECDEG - 1 + CELDEG;   // top degree of the boundary moments
  static constexpr int NB = tri(DB + 1);
  static constexpr int NXI = tri(RECDEG);          // monomials of degree <= RECDEG - 1
  // Shared-memory rows of kTile values:
  static constexpr int IN = 0;               // the 40 inputs, in pack_inputs' order
  static constexpr int MU = IN + kInputs;    // mu(a, b) = sum_q w x^a y^b over the cell
  static constexpr int K = MU + NMU;         // L of K = L L^T, inverse diagonal, packed lower
  static constexpr int GR = K + tri(NR);     // gr, then Y = L^-1 gr: [D][NR], column-major
  static constexpr int ZM = GR + NR * D;     // -L_F^T / sqrt|T|: [4][NFM], packed (b, a), a <= b
  static constexpr int ZT = ZM + 4 * NFM;    // L_F^-1 T_F / sqrt|T|: [4][FBS][CBS]
  static constexpr int ROWS = ZT + 4 * FBS * CBS;
  static constexpr int WARPS = warps_for(CELDEG, FACDEG);
  static constexpr int MIN_BLOCKS = min_blocks_for(CELDEG, FACDEG);
  static constexpr int JOBS = 10;            // P1: cell, boundary, 4 x face stab, 4 x face cols
  static_assert(CBS <= RBS, "the cell basis nests in the reconstruction basis");
  static_assert(RECDEG <= 3 && DB <= 5, "quadrature and monomial tables stop at degree 5");
};

template <typename T, class S>
constexpr long long smem_bytes() {
  return static_cast<long long>(S::ROWS) * kTile * sizeof(T);
}

// One cell's view of the tile's shared memory: row r of this lane's cell.
template <typename T>
struct Tile {
  T* rows;
  int lane;
  __device__ T& operator()(int r) const { return rows[r * kTile + lane]; }
};

// This lane's cell: its packed inputs in shared memory, in pack_inputs' order: corners
// (x, y of corner v at 2v, 2v+1), bar (8, 9), diam (10), meas (11), normals (x, y of face f at
// 12 + 2f), fgeo (face f's barycenter x/y, face-basis base vector x/y, length at 20 + 5f).
template <typename T, class S>
struct Cell {
  Tile<T> t;
  T inv_h;  // scaled coordinate = (p - bar) 2/h
  __device__ explicit Cell(Tile<T> tile) : t(tile), inv_h(T(2) / tile(S::IN + 10)) {}
  __device__ T x(int v) const { return t(S::IN + 2 * v); }
  __device__ T y(int v) const { return t(S::IN + 2 * v + 1); }
  __device__ T bar_x() const { return t(S::IN + 8); }
  __device__ T bar_y() const { return t(S::IN + 9); }
  __device__ T area() const { return t(S::IN + 11); }
  __device__ T normal(int f, int xy) const { return t(S::IN + 12 + 2 * f + xy); }
  __device__ T face(int f, int e) const { return t(S::IN + 20 + 5 * f + e); }
};

// Point t of [-1, 1] on the segment e0 -> e1 (face f runs from corner f to corner f + 1).
template <typename T>
struct Segment {
  T x0, y0, x1, y1, half_length;
  template <class C>
  __device__ Segment(const C& in, int f)
      : x0(in.x(f)), y0(in.y(f)), x1(in.x((f + 1) & 3)), y1(in.y((f + 1) & 3)) {
    half_length = T(0.5) * sqrt((x1 - x0) * (x1 - x0) + (y1 - y0) * (y1 - y0));
  }
  __device__ T px(T t) const { return T(0.5) * (1 - t) * x0 + T(0.5) * (1 + t) * x1; }
  __device__ T py(T t) const { return T(0.5) * (1 - t) * y0 + T(0.5) * (1 + t) * y1; }
};

template <int DEG, typename T>
__device__ __forceinline__ void powers(T x, T (&p)[DEG + 1]) {
  p[0] = T(1);
#pragma unroll
  for (int k = 1; k <= DEG; ++k) p[k] = p[k - 1] * x;
}

// acc[m] += w x^a y^b for every monomial m = (a, b) of degree <= DEG.
template <int DEG, typename T, int N>
__device__ __forceinline__ void add_moments(T (&acc)[N], T w, T x, T y) {
  static_assert(N == tri(DEG + 1), "one accumulator per monomial");
  T px[DEG + 1], py[DEG + 1];
  powers<DEG>(x, px);
  powers<DEG>(y, py);
#pragma unroll
  for (int m = 0; m < N; ++m) acc[m] += (w * px[exp_x(m)]) * py[exp_y(m)];
}

// The scaled monomials' gradients are scaled monomials: d/dx x^a y^b = a x^(a-1) y^b 2/h.
// So the reconstruction stiffness and the face couplings are fixed combinations of a few
// weighted monomial moments (all sums over the same quadrature points as the plain version):
//   K[p][r]     = (2/h)^2 [a_p a_r mu(a_p+a_r-2, b_p+b_r) + b_p b_r mu(a_p+a_r, b_p+b_r-2)]
//   corr[p][j]  = (2/h) [a_p bx(a_p-1+a_j, b_p+b_j) + b_p by(a_p+a_j, b_p-1+b_j)]
// with mu over the cell rule and bx, by over the four face rules (hho.hpp:55-85).

// P1 (a): cell moments mu (hho.hpp:55-64's quadrature) to shared memory, then K formed
// from them in registers and factored K = L L^T row by row: row i is reduced against the
// rows of L already in shared memory and stored (1 / L_ii on the diagonal), so only one
// row is live in registers.
template <typename T, class S, int I = 0>
__device__ __forceinline__ void cholesky_rows(const T (&mu)[S::NMU], T invh2, Tile<T> t) {
  if constexpr (I < S::NR) {
    constexpr int ap = exp_x(I + 1), bp = exp_y(I + 1);
    T row[S::NR];
#pragma unroll
    for (int j = 0; j <= I; ++j) {
      const int ar = exp_x(j + 1), br = exp_y(j + 1);
      T v = T(0);
      // (max keeps the index of a skipped term in range)
      if (ap > 0 && ar > 0) v += T(ap * ar) * mu[mono_index(max(ap + ar - 2, 0), bp + br)];
      if (bp > 0 && br > 0) v += T(bp * br) * mu[mono_index(ap + ar, max(bp + br - 2, 0))];
      v *= invh2;
#pragma unroll
      for (int k = 0; k < j; ++k) v -= row[k] * (j == I ? row[k] : t(S::K + tri(j) + k));
      row[j] = j == I ? rsqrt(v) : v * t(S::K + tri(j) + j);
    }
#pragma unroll
    for (int j = 0; j <= I; ++j) t(S::K + tri(I) + j) = row[j];
    __syncwarp();
    cholesky_rows<T, S, I + 1>(mu, invh2, t);
  }
}

template <typename T, class S>
__device__ void cell_job(const Cell<T, S>& in, Tile<T> t) {
  T X[4], Y[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    X[v] = in.x(v);
    Y[v] = in.y(v);
  }
  const T bx0 = in.bar_x(), by0 = in.bar_y(), invh = in.inv_h;
  T mu[S::NMU];
#pragma unroll
  for (int m = 0; m < S::NMU; ++m) mu[m] = T(0);
#pragma unroll
  for (int qj = 0; qj < S::NQC; ++qj) {
#pragma unroll
    for (int qi = 0; qi < S::NQC; ++qi) {
      const T xi = T(gl_node(S::NQC, qi)), eta = T(gl_node(S::NQC, qj));
      const T s0 = (1 - xi) * (1 - eta), s1 = (1 + xi) * (1 - eta);
      const T s2 = (1 + xi) * (1 + eta), s3 = (1 - xi) * (1 + eta);
      const T pxq = T(0.25) * (X[0] * s0 + X[1] * s1 + X[2] * s2 + X[3] * s3);
      const T pyq = T(0.25) * (Y[0] * s0 + Y[1] * s1 + Y[2] * s2 + Y[3] * s3);
      const T j11 = T(0.25) * ((X[1] - X[0]) * (1 - eta) + (X[2] - X[3]) * (1 + eta));
      const T j12 = T(0.25) * ((Y[1] - Y[0]) * (1 - eta) + (Y[2] - Y[3]) * (1 + eta));
      const T j21 = T(0.25) * ((X[3] - X[0]) * (1 - xi) + (X[2] - X[1]) * (1 + xi));
      const T j22 = T(0.25) * ((Y[3] - Y[0]) * (1 - xi) + (Y[2] - Y[1]) * (1 + xi));
      const T w = T(gl_weight(S::NQC, qj) * gl_weight(S::NQC, qi)) *
                  fabs(j11 * j22 - j12 * j21);
      add_moments<2 * S::RECDEG - 2>(mu, w, (pxq - bx0) * invh, (pyq - by0) * invh);
    }
  }
#pragma unroll
  for (int m = 0; m < S::NMU; ++m) t(S::MU + m) = mu[m];
  cholesky_rows<T, S>(mu, invh * invh, t);
}

// P1 (b): the boundary moments bx, then by, over the four face rules, each folded into the
// cell columns of gr as soon as it is complete: gr[j][i] = -corr[i+1][j]. The two passes stay
// a loop, so that they do not share (and keep live) the monomials of every face point.
template <typename T, class S>
__device__ void boundary_job(const Cell<T, S>& in, Tile<T> t) {
  const T bx0 = in.bar_x(), by0 = in.bar_y(), invh = in.inv_h;
#pragma unroll 1
  for (int xy = 0; xy < 2; ++xy) {
    T beta[S::NB];
#pragma unroll
    for (int m = 0; m < S::NB; ++m) beta[m] = T(0);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const Segment<T> e(in, f);
      const T wn = e.half_length * in.normal(f, xy);
#pragma unroll
      for (int q = 0; q < S::NQF; ++q) {
        const T tq = T(gl_node(S::NQF, q));
        add_moments<S::DB>(beta, T(gl_weight(S::NQF, q)) * wn, (e.px(tq) - bx0) * invh,
                           (e.py(tq) - by0) * invh);
      }
    }
#pragma unroll
    for (int i = 0; i < S::NR; ++i) {
      const int ap = exp_x(i + 1), bp = exp_y(i + 1);
#pragma unroll
      for (int j = 0; j < S::CBS; ++j) {
        const int aj = exp_x(j), bj = exp_y(j);
        const T cx = ap > 0 ? T(ap) * beta[mono_index(ap > 0 ? ap - 1 + aj : 0, bp + bj)] : T(0);
        const T cy = bp > 0 ? T(bp) * beta[mono_index(ap + aj, bp > 0 ? bp - 1 + bj : 0)] : T(0);
        T& g = t(S::GR + j * S::NR + i);
        g = xy == 0 ? -invh * cx : g - invh * cy;
      }
    }
  }
}

// P1 (c), face F (hho.hpp:99-148): face mass M_F and trace T_F over the face rule, then
// Z_F = [L_F^-1 T_F, -L_F^T] / sqrt|T| with M_F = L_F L_F^T, so that Z_F^T Z_F is face F's
// stabilization over |T| (blocks R_F^T M_F R_F, -T_F^T, M_F).
template <typename T, class S>
__device__ void face_stabilization_job(const Cell<T, S>& in, Tile<T> t, int f) {
  const Segment<T> e(in, f);
  const T bx0 = in.bar_x(), by0 = in.bar_y(), invh = in.inv_h;
  const T fbarx = in.face(f, 0), fbary = in.face(f, 1);
  const T fbasex = in.face(f, 2), fbasey = in.face(f, 3), fh = in.face(f, 4);
  const T inv_fh2 = T(4) / (fh * fh);

  T M[S::NFM], Tr[S::FBS][S::CBS];
#pragma unroll
  for (int m = 0; m < S::NFM; ++m) M[m] = T(0);
#pragma unroll
  for (int a = 0; a < S::FBS; ++a)
#pragma unroll
    for (int j = 0; j < S::CBS; ++j) Tr[a][j] = T(0);
#pragma unroll
  for (int q = 0; q < S::NQF; ++q) {
    const T tq = T(gl_node(S::NQF, q));
    const T pxq = e.px(tq), pyq = e.py(tq);
    const T w = T(gl_weight(S::NQF, q)) * e.half_length;
    T px[S::RECDEG + 1], py[S::RECDEG + 1];
    powers<S::RECDEG>((pxq - bx0) * invh, px);
    powers<S::RECDEG>((pyq - by0) * invh, py);
    const T ep = (fbasex * (pxq - fbarx) + fbasey * (pyq - fbary)) * inv_fh2;
    T fp[S::FBS];
    fp[0] = T(1);
#pragma unroll
    for (int a = 1; a < S::FBS; ++a) fp[a] = fp[a - 1] * ep;
#pragma unroll
    for (int a = 0; a < S::FBS; ++a) {
      const T wf = w * fp[a];
#pragma unroll
      for (int b = 0; b <= a; ++b) M[tri(a) + b] += wf * fp[b];
#pragma unroll
      for (int j = 0; j < S::CBS; ++j) Tr[a][j] += wf * (px[exp_x(j)] * py[exp_y(j)]);
    }
  }
  // M_F = L_F L_F^T in place; inv_d = 1 / diag(L_F)
  T inv_d[S::FBS];
#pragma unroll
  for (int a = 0; a < S::FBS; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      T v = M[tri(a) + b];
#pragma unroll
      for (int k = 0; k < b; ++k) v -= M[tri(a) + k] * M[tri(b) + k];
      if (a == b) {
        inv_d[a] = rsqrt(v);
        M[tri(a) + a] = v * inv_d[a];
      } else {
        M[tri(a) + b] = v * inv_d[b];
      }
    }
  }
  const T rs = rsqrt(in.area());
#pragma unroll
  for (int j = 0; j < S::CBS; ++j) {
#pragma unroll
    for (int a = 0; a < S::FBS; ++a) {
      T v = Tr[a][j];
#pragma unroll
      for (int k = 0; k < a; ++k) v -= M[tri(a) + k] * Tr[k][j];
      Tr[a][j] = v * inv_d[a];
      t(S::ZT + (f * S::FBS + a) * S::CBS + j) = Tr[a][j] * rs;
    }
  }
#pragma unroll
  for (int m = 0; m < S::NFM; ++m) t(S::ZM + f * S::NFM + m) = -M[m] * rs;
}

// P1 (d), face F: its columns of gr, (grad r_p . n_F, v_F)_F (hho.hpp:82-83), from the
// moments xi(m, e) = sum_q w x^a y^b ep^e over the face rule, for monomials m = (a, b) of
// degree <= RECDEG - 1 (the gradients' degree) and face-basis powers e.
template <typename T, class S>
__device__ void face_columns_job(const Cell<T, S>& in, Tile<T> t, int f) {
  const Segment<T> seg(in, f);
  const T bx0 = in.bar_x(), by0 = in.bar_y(), invh = in.inv_h;
  const T fbarx = in.face(f, 0), fbary = in.face(f, 1);
  const T fbasex = in.face(f, 2), fbasey = in.face(f, 3), fh = in.face(f, 4);
  const T inv_fh2 = T(4) / (fh * fh);
  const T nx = in.normal(f, 0), ny = in.normal(f, 1);
  T xi[S::FBS][S::NXI];
#pragma unroll
  for (int e = 0; e < S::FBS; ++e)
#pragma unroll
    for (int m = 0; m < S::NXI; ++m) xi[e][m] = T(0);
#pragma unroll
  for (int q = 0; q < S::NQF; ++q) {
    const T tq = T(gl_node(S::NQF, q));
    const T pxq = seg.px(tq), pyq = seg.py(tq);
    const T ep = (fbasex * (pxq - fbarx) + fbasey * (pyq - fbary)) * inv_fh2;
    T w = T(gl_weight(S::NQF, q)) * seg.half_length;
#pragma unroll
    for (int e = 0; e < S::FBS; ++e) {
      add_moments<S::RECDEG - 1>(xi[e], w, (pxq - bx0) * invh, (pyq - by0) * invh);
      w *= ep;
    }
  }
#pragma unroll
  for (int i = 0; i < S::NR; ++i) {
    const int a = exp_x(i + 1), c = exp_y(i + 1);
#pragma unroll
    for (int e = 0; e < S::FBS; ++e) {
      T v = T(0);
      if (a > 0) v += T(a) * nx * xi[e][mono_index(a > 0 ? a - 1 : 0, c)];
      if (c > 0) v += T(c) * ny * xi[e][mono_index(a, c > 0 ? c - 1 : 0)];
      t(S::GR + (S::CBS + f * S::FBS + e) * S::NR + i) = invh * v;
    }
  }
}

// P2: the columns col0, col0 + WARPS, ... of gr. A cell column j first gets its stiffness
// part, stiff[i+1][j] (from mu), beside the -corr that P1 (b) left there; then all of them
// become columns of Y = L^-1 gr, solved together so that each entry of L is read once.
template <typename T, class S>
__device__ void solve_columns(Tile<T> t, T invh, int col0) {
  constexpr int NC = (S::D + S::WARPS - 1) / S::WARPS;
  const T invh2 = invh * invh;
  T y[NC][S::NR];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = min(col0 + c * S::WARPS, S::D - 1);
#pragma unroll
    for (int r = 0; r < S::NR; ++r) y[c][r] = t(S::GR + col * S::NR + r);
    if (col < S::CBS) {
      const int aj = exp_x(col), bj = exp_y(col);
#pragma unroll
      for (int r = 0; r < S::NR; ++r) {
        const int ap = exp_x(r + 1), bp = exp_y(r + 1);
        T stiff = T(0);
        if (aj > 0 && ap > 0) stiff += T(ap * aj) * t(S::MU + mono_index(ap + aj - 2, bp + bj));
        if (bj > 0 && bp > 0) stiff += T(bp * bj) * t(S::MU + mono_index(ap + aj, bp + bj - 2));
        y[c][r] += invh2 * stiff;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < S::NR; ++r) {
#pragma unroll
    for (int k = 0; k < r; ++k) {
      const T l = t(S::K + tri(r) + k);
#pragma unroll
      for (int c = 0; c < NC; ++c) y[c][r] -= l * y[c][k];
    }
    const T inv_d = t(S::K + tri(r) + r);
#pragma unroll
    for (int c = 0; c < NC; ++c) y[c][r] *= inv_d;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col0 + c * S::WARPS;
    if (col < S::D) {
#pragma unroll
      for (int r = 0; r < S::NR; ++r) t(S::GR + col * S::NR + r) = y[c][r];
    }
  }
}

// Stabilization term of lc[i][j], i <= j, for a face column j: sum_F Z_F[:, i] Z_F[:, j]
// over the one face F of column j (Z_F's columns meet only the cell and face F).
template <typename T, class S>
__device__ __forceinline__ T face_term(Tile<T> t, int i, int j) {
  const int g = (j - S::CBS) / S::FBS, b = j - S::CBS - g * S::FBS;
  const int zm = S::ZM + g * S::NFM;
  T v = T(0);
  if (i < S::CBS) {
    for (int a = 0; a <= b; ++a) v += t(S::ZT + (g * S::FBS + a) * S::CBS + i) * t(zm + tri(b) + a);
  } else if ((i - S::CBS) / S::FBS == g) {
    const int ai = i - S::CBS - g * S::FBS;
    for (int a = 0; a <= ai; ++a) v += t(zm + tri(ai) + a) * t(zm + tri(b) + a);
  }
  return v;
}

// P3: row i of lc = Y^T Y + sum_F Z_F^T Z_F from column i on, each value stored at (i, j)
// and (j, i). Every store of a warp is 32 consecutive values of one output row.
template <typename T, class S>
__device__ void output_row(Tile<T> t, int i, T* __restrict__ out, long long C, long long cell,
                           bool live) {
  T y[S::NR], z[4 * S::FBS];
#pragma unroll
  for (int r = 0; r < S::NR; ++r) y[r] = t(S::GR + i * S::NR + r);
#pragma unroll
  for (int m = 0; m < 4 * S::FBS; ++m)
    z[m] = i < S::CBS ? t(S::ZT + m * S::CBS + min(i, S::CBS - 1)) : T(0);
  for (int j = i; j < S::D; ++j) {
    T v = T(0);
#pragma unroll
    for (int r = 0; r < S::NR; ++r) v += y[r] * t(S::GR + j * S::NR + r);
    if (j < S::CBS) {
#pragma unroll
      for (int m = 0; m < 4 * S::FBS; ++m) v += z[m] * t(S::ZT + m * S::CBS + j);
    } else {
      v += face_term<T, S>(t, i, j);
    }
    if (live) {
      out[static_cast<long long>(i * S::D + j) * C + cell] = v;
      if (j != i) out[static_cast<long long>(j * S::D + i) * C + cell] = v;
    }
  }
}

// The packed cells-last inputs: corners [4, 2, C]; bar [2, C]; diam, meas [1, C];
// normals [4, 2, C]; fgeo [4, 5, C]. Row e of the 40 is pack_inputs' order.
template <typename T>
struct Inputs {
  const T* corners;
  const T* bar;
  const T* diam;
  const T* meas;
  const T* normals;
  const T* fgeo;
  long long C;
  __device__ const T* row(int e) const {
    return e < 8     ? corners + e * C
           : e < 10  ? bar + (e - 8) * C
           : e == 10 ? diam
           : e == 11 ? meas
           : e < 20  ? normals + (e - 12) * C
                     : fgeo + (e - 20) * C;
  }
};

// The tile's 40 input rows into shared memory with asynchronous copies (cp.async, one
// value per lane, coalesced over the warp); rows warp, warp + WARPS, ... Lanes past the
// last cell copy the tile's first cell: finite values, never stored.
template <typename T, class S>
__device__ __forceinline__ void request_inputs(const Inputs<T>& in, Tile<T> t,
                                               long long tile, int warp) {
  const long long cell = tile * kTile + t.lane;
  const long long src = cell < in.C ? cell : tile * kTile;
  for (int e = warp; e < kInputs; e += S::WARPS) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&t(S::IN + e)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(in.row(e) + src), "n"(sizeof(T)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_inputs() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int CELDEG, int FACDEG>
__global__ void __launch_bounds__(Shape<CELDEG, FACDEG>::WARPS * 32,
                                  Shape<CELDEG, FACDEG>::MIN_BLOCKS)
fused_assembly_kernel(Inputs<T> inputs, T* __restrict__ out) {
  using S = Shape<CELDEG, FACDEG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile<T> t{reinterpret_cast<T*>(smem), lane};
  const long long C = inputs.C, tiles = (C + kTile - 1) / kTile;

  request_inputs<T, S>(inputs, t, blockIdx.x, warp);
  wait_inputs();
  __syncthreads();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // P1: cell job (moments, K, L), boundary job, face stabilization (4), face columns (4)
    const Cell<T, S> in(t);
    const T invh = in.inv_h;
    for (int r = 0; r * S::WARPS < S::JOBS; ++r) {
      // jobs dealt in snake order: the two long ones (0, 1) share their warps with face
      // column jobs (the lightest) at most
      const int job = r * S::WARPS + ((r & 1) ? S::WARPS - 1 - warp : warp);
      if (job >= S::JOBS)
        continue;
      else if (job == 0)
        cell_job<T, S>(in, t);
      else if (job == 1)
        boundary_job<T, S>(in, t);
      else if (job < 6)
        face_stabilization_job<T, S>(in, t, job - 2);
      else
        face_columns_job<T, S>(in, t, job - 6);
    }
    __syncthreads();
    // P2: Y = L^-1 gr, columns over the warps
    if (warp < S::D) solve_columns<T, S>(t, invh, warp);
    __syncthreads();
    // P3, with the next tile's inputs in flight: rows dealt to the warps in snake order
    // (row i holds d - i entries)
    if (tile + gridDim.x < tiles) request_inputs<T, S>(inputs, t, tile + gridDim.x, warp);
    const long long cell = tile * kTile + lane;
    for (int r = 0; r * S::WARPS < S::D; ++r) {
      const int i = r * S::WARPS + ((r & 1) ? S::WARPS - 1 - warp : warp);
      if (i < S::D) output_row<T, S>(t, i, out, C, cell, cell < C);
    }
    wait_inputs();
    __syncthreads();
  }
}

// Launch constants of one instantiation on the current card: the dynamic shared-memory
// limit raised (needed above 48 KB), and the first wave of blocks (resident per SM x SMs).
struct Residency {
  int err = -100;  // not yet queried
  unsigned first_wave = 0, num_sms = 0;
};

struct LaunchArgs {
  const void* in[6];  // corners, bar, diam, meas, normals, fgeo
  void* out;
  long long C;
  int tile_cells, warps;
  long long smem;
  cudaStream_t stream;
};

template <typename T, int CD, int FD>
const Residency& residency() {
  using S = Shape<CD, FD>;
  static Residency r;
  if (r.err == 0) return r;
  int dev = 0, sms = 0, blocks = 0;
  r.err = static_cast<int>(cudaGetDevice(&dev));
  if (!r.err)
    r.err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!r.err)
    r.err = static_cast<int>(cudaFuncSetAttribute(fused_assembly_kernel<T, CD, FD>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(smem_bytes<T, S>())));
  if (!r.err)
    r.err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_assembly_kernel<T, CD, FD>, S::WARPS * 32, smem_bytes<T, S>()));
  if (!r.err && blocks == 0) r.err = static_cast<int>(cudaErrorInvalidConfiguration);
  r.num_sms = static_cast<unsigned>(sms);
  r.first_wave = static_cast<unsigned>(blocks * sms);
  return r;
}

template <typename T, int CD, int FD>
int launch(const LaunchArgs& a) {
  using S = Shape<CD, FD>;
  if (a.tile_cells != kTile || a.warps != S::WARPS || a.smem != smem_bytes<T, S>()) return -3;
  if (a.C <= 0) return 0;
  const Residency& r = residency<T, CD, FD>();
  if (r.err) return r.err;
  const long long tiles = (a.C + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>(tiles < r.first_wave ? tiles : r.first_wave);
  const Inputs<T> in{static_cast<const T*>(a.in[0]), static_cast<const T*>(a.in[1]),
                     static_cast<const T*>(a.in[2]), static_cast<const T*>(a.in[3]),
                     static_cast<const T*>(a.in[4]), static_cast<const T*>(a.in[5]), a.C};
  fused_assembly_kernel<T, CD, FD>
      <<<blocks, S::WARPS * 32, smem_bytes<T, S>(), a.stream>>>(in, static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CD, int FD>
int occupancy(int* blocks_per_sm) {
  const Residency& r = residency<T, CD, FD>();
  if (r.err) return r.err;
  *blocks_per_sm = static_cast<int>(r.first_wave / r.num_sms);
  return 0;
}

// Launches (args given) or reports the blocks per SM (blocks_per_sm given).
template <typename T, int CD, int FD>
int run(const LaunchArgs* args, int* blocks_per_sm) {
  return args ? launch<T, CD, FD>(*args) : occupancy<T, CD, FD>(blocks_per_sm);
}

template <typename T>
int dispatch(int cd, int fd, const LaunchArgs* args, int* blocks_per_sm) {
  if (cd == 1 && fd == 0) return run<T, 1, 0>(args, blocks_per_sm);
  if (cd == 2 && fd == 1) return run<T, 2, 1>(args, blocks_per_sm);
  if (cd == 3 && fd == 2) return run<T, 3, 2>(args, blocks_per_sm);
  if (cd == 1 && fd == 1) return run<T, 1, 1>(args, blocks_per_sm);
  return -1;
}

bool tables_match(int face_degree, const double* gx, const double* gw, int nqc,
                  const double* fx, const double* fw, int nqf, const int* px,
                  const int* py, int rbs) {
  const int recdeg = face_degree + 1;
  if (recdeg > 3 || nqc != recdeg + 1 || nqf != face_degree + 1 ||
      rbs != (recdeg + 1) * (recdeg + 2) / 2)
    return false;
  auto close = [](double a, double b) { return a - b <= 1e-14 && b - a <= 1e-14; };
  for (int q = 0; q < nqc; ++q)
    if (!close(gx[q], gl_node(nqc, q)) || !close(gw[q], gl_weight(nqc, q))) return false;
  for (int q = 0; q < nqf; ++q)
    if (!close(fx[q], gl_node(nqf, q)) || !close(fw[q], gl_weight(nqf, q))) return false;
  for (int b = 0; b < rbs; ++b)
    if (px[b] != exp_x(b) || py[b] != exp_y(b)) return false;
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, -1 for a degree
// pair without an instantiation, -2 for quadrature or basis tables that differ from the
// compiled ones, -3 for a launch geometry (cells per tile, warps, shared-memory bytes)
// that differs from the compiled one.
int fused_assembly_launch(int is_f64, int cell_degree, int face_degree, const void* corners,
                          const void* bar, const void* diam, const void* meas,
                          const void* normals, const void* fgeo, void* out,
                          long long n_cells, const double* gx, const double* gw, int nqc,
                          const double* fx, const double* fw, int nqf, const int* px,
                          const int* py, int rbs, int tile_cells, int warps,
                          long long smem_bytes, void* stream) {
  if (!tables_match(face_degree, gx, gw, nqc, fx, fw, nqf, px, py, rbs)) return -2;
  const LaunchArgs args{{corners, bar, diam, meas, normals, fgeo}, out, n_cells,
                        tile_cells, warps, smem_bytes, static_cast<cudaStream_t>(stream)};
  return is_f64 ? dispatch<double>(cell_degree, face_degree, &args, nullptr)
                : dispatch<float>(cell_degree, face_degree, &args, nullptr);
}

// Resident blocks per SM of one instantiation at its launch geometry
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); same return codes.
int fused_assembly_occupancy(int is_f64, int cell_degree, int face_degree,
                             int* blocks_per_sm) {
  return is_f64 ? dispatch<double>(cell_degree, face_degree, nullptr, blocks_per_sm)
                : dispatch<float>(cell_degree, face_degree, nullptr, blocks_per_sm);
}

const char* fused_assembly_error_string(int code) {
  if (code == -1) return "no kernel instantiated for this (cell_degree, face_degree)";
  if (code == -2) return "quadrature or basis tables differ from the compiled ones";
  if (code == -3) return "launch geometry differs from the compiled kernel's";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
