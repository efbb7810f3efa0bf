// Fused fitted-HHO local assembly on quadrilateral cells, one thread per cell.
//
// Replaces the TPU kernel proton_tpu/methods/pallas_assembly.py:fused_local_operator
// (pl.pallas_call at :340, kernel body _make_kernel). For every quad cell it computes
// lc = a_T + s_T: the gradient-reconstruction form (tensor Gauss-Legendre quadrature on
// the bilinear map, scaled-monomial gradients, reconstruction stiffness, face couplings
// gr, a Cholesky solve, lc = gr^T (K^-1 gr)) plus the naive face stabilization
// sum_F (R_F^T M_F R_F) / |T|. The plain PyTorch version of the same function is
// proton_tpu_torch/methods/fused_assembly.py:fitted_local_operator_plain.
//
// Bound. At the main-path shape (1024^2 cells, k=1, float64) the kernel reads 40 values
// and writes 196 values per cell: 1,888 B x 1,048,576 cells = 1.98 GB, 0.59 ms at the
// H100 SXM's 3.35 TB/s. Its ~6 kFLOP per cell take ~0.19 ms at the 34 TFLOP/s float64
// vector peak, so the bytes bound it. chip_smoke.py recomputes the bound for the card it
// runs on.
//
// Design. Inputs and output are cells-last ([entries, C]): neighbouring threads handle
// neighbouring cells, so every input load and every lc store is coalesced across the warp,
// and each input byte is read once and each output byte written once. The quadrature nodes,
// weights and basis exponents come from the caller (the port's gauss_legendre and
// _exponent_tables), so the kernel and the plain version integrate with the same rule.
// The per-cell working set (stiffness, gr, stabilization blocks: ~0.5k values at k=2) does
// not fit in registers and spills to local memory; keeping it on chip (a warp per cell,
// shared-memory staging of gr) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNodes = 8;
constexpr int kMaxBasis = 28;
constexpr int kThreads = 128;

struct Tables {
  double gx[kMaxNodes];  // cell rule: GL nodes per axis on [-1, 1]
  double gw[kMaxNodes];
  double fx[kMaxNodes];  // face rule: GL nodes on [-1, 1]
  double fw[kMaxNodes];
  int px[kMaxBasis];     // x / y exponents of the reconstruction basis
  int py[kMaxBasis];
};

// In-place Cholesky (lower triangle) of an N x N row-major matrix.
template <typename T, int N>
__device__ inline void cholesky(T (&a)[N][N]) {
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j <= i; ++j) {
      T s = a[i][j];
      for (int k = 0; k < j; ++k) s -= a[i][k] * a[j][k];
      a[i][j] = (i == j) ? sqrt(s) : s / a[j][j];
    }
  }
}

// B <- L^-1 B for lower-triangular L (N x N) and B (N x M).
template <typename T, int N, int M>
__device__ inline void forward_solve(T (&L)[N][N], T (&B)[N][M]) {
  for (int i = 0; i < N; ++i)
    for (int c = 0; c < M; ++c) {
      T s = B[i][c];
      for (int k = 0; k < i; ++k) s -= L[i][k] * B[k][c];
      B[i][c] = s / L[i][i];
    }
}

// B <- L^-T B.
template <typename T, int N, int M>
__device__ inline void backward_solve(T (&L)[N][N], T (&B)[N][M]) {
  for (int i = N - 1; i >= 0; --i)
    for (int c = 0; c < M; ++c) {
      T s = B[i][c];
      for (int k = i + 1; k < N; ++k) s -= L[k][i] * B[k][c];
      B[i][c] = s / L[i][i];
    }
}

// Scaled monomials of degree <= DEG at b = (p - bar) * 2/h, and their gradients.
template <typename T, int DEG, int B>
__device__ inline void basis(T bx, T by, T invh, const Tables& tab, T (&phi)[B],
                             T (&dx)[B], T (&dy)[B]) {
  T powx[DEG + 1], powy[DEG + 1];
  powx[0] = T(1);
  powy[0] = T(1);
  for (int p = 1; p <= DEG; ++p) {
    powx[p] = powx[p - 1] * bx;
    powy[p] = powy[p - 1] * by;
  }
  for (int b = 0; b < B; ++b) {
    const int ex = tab.px[b], ey = tab.py[b];
    phi[b] = powx[ex] * powy[ey];
    dx[b] = ex > 0 ? T(ex) * powx[ex - 1] * invh * powy[ey] : T(0);
    dy[b] = ey > 0 ? powx[ex] * (T(ey) * powy[ey - 1] * invh) : T(0);
  }
}

template <typename T, int CELDEG, int FACDEG>
__global__ void __launch_bounds__(kThreads)
fused_assembly_kernel(const T* __restrict__ corners, const T* __restrict__ bar,
                      const T* __restrict__ diam, const T* __restrict__ meas,
                      const T* __restrict__ normals, const T* __restrict__ fgeo,
                      T* __restrict__ out, long long C, Tables tab) {
  constexpr int RECDEG = FACDEG + 1;
  constexpr int RBS = (RECDEG + 1) * (RECDEG + 2) / 2;
  constexpr int CBS = (CELDEG + 1) * (CELDEG + 2) / 2;
  constexpr int FBS = FACDEG + 1;
  constexpr int D = CBS + 4 * FBS;
  constexpr int NR = RBS - 1;
  constexpr int NQC = RECDEG + 1;  // GL nodes of degree 2*RECDEG
  constexpr int NQF = FACDEG + 1;  // GL nodes of degree 2*FACDEG
  static_assert(CBS <= RBS, "the cell basis nests in the reconstruction basis");

  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= C) return;

  // corners [4, 2, C]; bar [2, C]; diam, meas [1, C]; normals [4, 2, C];
  // fgeo [4, 5, C] = (face barycenter x/y, face-basis base vector x/y, face length)
  T X[4], Y[4];
  for (int v = 0; v < 4; ++v) {
    X[v] = corners[(2 * v) * C + c];
    Y[v] = corners[(2 * v + 1) * C + c];
  }
  const T bx0 = bar[c], by0 = bar[C + c];
  const T invh = T(2) / diam[c];
  const T inv_meas = T(1) / meas[c];

  T phi[RBS], dx[RBS], dy[RBS];

  // reconstruction stiffness (hho.hpp:55-64), lower triangle
  T stiff[RBS][RBS];
  for (int i = 0; i < RBS; ++i)
    for (int j = 0; j < RBS; ++j) stiff[i][j] = T(0);
  for (int qj = 0; qj < NQC; ++qj) {
    for (int qi = 0; qi < NQC; ++qi) {
      const T xi = T(tab.gx[qi]), eta = T(tab.gx[qj]);
      const T s0 = (1 - xi) * (1 - eta), s1 = (1 + xi) * (1 - eta);
      const T s2 = (1 + xi) * (1 + eta), s3 = (1 - xi) * (1 + eta);
      const T pxq = T(0.25) * (X[0] * s0 + X[1] * s1 + X[2] * s2 + X[3] * s3);
      const T pyq = T(0.25) * (Y[0] * s0 + Y[1] * s1 + Y[2] * s2 + Y[3] * s3);
      const T j11 = T(0.25) * ((X[1] - X[0]) * (1 - eta) + (X[2] - X[3]) * (1 + eta));
      const T j12 = T(0.25) * ((Y[1] - Y[0]) * (1 - eta) + (Y[2] - Y[3]) * (1 + eta));
      const T j21 = T(0.25) * ((X[3] - X[0]) * (1 - xi) + (X[2] - X[1]) * (1 + xi));
      const T j22 = T(0.25) * ((Y[3] - Y[0]) * (1 - xi) + (Y[2] - Y[1]) * (1 + xi));
      const T w = T(tab.gw[qj] * tab.gw[qi]) * fabs(j11 * j22 - j12 * j21);
      basis<T, RECDEG, RBS>((pxq - bx0) * invh, (pyq - by0) * invh, invh, tab, phi, dx, dy);
      for (int i = 1; i < RBS; ++i)
        for (int j = 1; j <= i; ++j) stiff[i][j] += w * (dx[i] * dx[j] + dy[i] * dy[j]);
    }
  }
  for (int i = 0; i < RBS; ++i)
    for (int j = i + 1; j < RBS; ++j) stiff[i][j] = stiff[j][i];

  // gr [NR, D]: cell columns from the stiffness, face columns from the face loop
  T gr[NR][D];
  for (int i = 0; i < NR; ++i)
    for (int j = 0; j < D; ++j) gr[i][j] = j < CBS ? stiff[i + 1][j] : T(0);

  T stab_cc[CBS][CBS];
  for (int i = 0; i < CBS; ++i)
    for (int j = 0; j < CBS; ++j) stab_cc[i][j] = T(0);
  T fmass_f[4][FBS][FBS];   // face mass per face
  T ftrace_f[4][FBS][CBS];  // face-cell trace per face

  for (int f = 0; f < 4; ++f) {
    const T e0x = X[f], e0y = Y[f], e1x = X[(f + 1) & 3], e1y = Y[(f + 1) & 3];
    const T nx = normals[(2 * f) * C + c], ny = normals[(2 * f + 1) * C + c];
    const T fbarx = fgeo[(5 * f) * C + c], fbary = fgeo[(5 * f + 1) * C + c];
    const T fbasex = fgeo[(5 * f + 2) * C + c], fbasey = fgeo[(5 * f + 3) * C + c];
    const T fh = fgeo[(5 * f + 4) * C + c];
    const T seg = T(0.5) * sqrt((e1x - e0x) * (e1x - e0x) + (e1y - e0y) * (e1y - e0y));
    const T inv_fh2 = T(4) / (fh * fh);

    T (&fmass)[FBS][FBS] = fmass_f[f];
    T (&ftrace)[FBS][CBS] = ftrace_f[f];
    for (int a = 0; a < FBS; ++a) {
      for (int b = 0; b < FBS; ++b) fmass[a][b] = T(0);
      for (int j = 0; j < CBS; ++j) ftrace[a][j] = T(0);
    }
    for (int q = 0; q < NQF; ++q) {
      const T t = T(tab.fx[q]);
      const T pxq = T(0.5) * (1 - t) * e0x + T(0.5) * (1 + t) * e1x;
      const T pyq = T(0.5) * (1 - t) * e0y + T(0.5) * (1 + t) * e1y;
      const T w = T(tab.fw[q]) * seg;
      basis<T, RECDEG, RBS>((pxq - bx0) * invh, (pyq - by0) * invh, invh, tab, phi, dx, dy);
      const T ep = (fbasex * (pxq - fbarx) + fbasey * (pyq - fbary)) * inv_fh2;
      T fphi[FBS];
      fphi[0] = T(1);
      for (int p = 1; p < FBS; ++p) fphi[p] = fphi[p - 1] * ep;
      // face couplings (grad r . n, v_F - v_T) (hho.hpp:66-85)
      for (int i = 0; i < NR; ++i) {
        const T wdn = w * (dx[i + 1] * nx + dy[i + 1] * ny);
        for (int b = 0; b < FBS; ++b) gr[i][CBS + f * FBS + b] += wdn * fphi[b];
        for (int j = 0; j < CBS; ++j) gr[i][j] -= wdn * phi[j];
      }
      // stabilization mass and trace (hho.hpp:132-140)
      for (int a = 0; a < FBS; ++a) {
        const T wf = w * fphi[a];
        for (int b = 0; b <= a; ++b) fmass[a][b] += wf * fphi[b];
        for (int j = 0; j < CBS; ++j) ftrace[a][j] += wf * phi[j];
      }
    }
    for (int a = 0; a < FBS; ++a)
      for (int b = a + 1; b < FBS; ++b) fmass[a][b] = fmass[b][a];

    // R = M^-1 trace; (cell, cell) += R^T M R = R^T trace
    T L[FBS][FBS];
    T R[FBS][CBS];
    for (int a = 0; a < FBS; ++a) {
      for (int b = 0; b < FBS; ++b) L[a][b] = fmass[a][b];
      for (int j = 0; j < CBS; ++j) R[a][j] = ftrace[a][j];
    }
    cholesky<T, FBS>(L);
    forward_solve<T, FBS, CBS>(L, R);
    backward_solve<T, FBS, CBS>(L, R);
    for (int i = 0; i < CBS; ++i)
      for (int j = 0; j < CBS; ++j) {
        T s = T(0);
        for (int a = 0; a < FBS; ++a) s += R[a][i] * ftrace[a][j];
        stab_cc[i][j] += s;
      }
  }

  // reconstruction solve: with K = stiff[1:, 1:] = L L^T, a_T = (L^-1 gr)^T (L^-1 gr)
  T K[NR][NR];
  for (int i = 0; i < NR; ++i)
    for (int j = 0; j < NR; ++j) K[i][j] = stiff[i + 1][j + 1];
  cholesky<T, NR>(K);
  forward_solve<T, NR, D>(K, gr);

  // lc = a_T + s_T; the stabilization is block sparse:
  // (cell, cell) R^T M R; (cell, face F) -trace_F^T; (face F, face F) M_F; all / |T|
  for (int i = 0; i < D; ++i) {
    for (int j = 0; j < D; ++j) {
      T v = T(0);
      for (int r = 0; r < NR; ++r) v += gr[r][i] * gr[r][j];
      T s = T(0);
      if (i < CBS && j < CBS) {
        s = stab_cc[i][j];
      } else if (i < CBS) {
        s = -ftrace_f[(j - CBS) / FBS][(j - CBS) % FBS][i];
      } else if (j < CBS) {
        s = -ftrace_f[(i - CBS) / FBS][(i - CBS) % FBS][j];
      } else if ((i - CBS) / FBS == (j - CBS) / FBS) {
        s = fmass_f[(i - CBS) / FBS][(i - CBS) % FBS][(j - CBS) % FBS];
      }
      out[static_cast<long long>(i * D + j) * C + c] = v + s * inv_meas;
    }
  }
}

template <typename T, int CELDEG, int FACDEG>
int launch(const void* corners, const void* bar, const void* diam, const void* meas,
           const void* normals, const void* fgeo, void* out, long long C,
           const Tables& tab, cudaStream_t stream) {
  if (C <= 0) return 0;
  const long long blocks = (C + kThreads - 1) / kThreads;
  fused_assembly_kernel<T, CELDEG, FACDEG><<<static_cast<unsigned>(blocks), kThreads, 0,
                                             stream>>>(
      static_cast<const T*>(corners), static_cast<const T*>(bar),
      static_cast<const T*>(diam), static_cast<const T*>(meas),
      static_cast<const T*>(normals), static_cast<const T*>(fgeo), static_cast<T*>(out), C,
      tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int cell_degree, int face_degree, const void* corners, const void* bar,
             const void* diam, const void* meas, const void* normals, const void* fgeo,
             void* out, long long C, const Tables& tab, cudaStream_t s) {
  if (cell_degree == 1 && face_degree == 0)
    return launch<T, 1, 0>(corners, bar, diam, meas, normals, fgeo, out, C, tab, s);
  if (cell_degree == 2 && face_degree == 1)
    return launch<T, 2, 1>(corners, bar, diam, meas, normals, fgeo, out, C, tab, s);
  if (cell_degree == 3 && face_degree == 2)
    return launch<T, 3, 2>(corners, bar, diam, meas, normals, fgeo, out, C, tab, s);
  if (cell_degree == 1 && face_degree == 1)
    return launch<T, 1, 1>(corners, bar, diam, meas, normals, fgeo, out, C, tab, s);
  return -1;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, -1 for a degree
// pair without an instantiation, -2 for quadrature tables of the wrong size.
int fused_assembly_launch(int is_f64, int cell_degree, int face_degree, const void* corners,
                          const void* bar, const void* diam, const void* meas,
                          const void* normals, const void* fgeo, void* out,
                          long long n_cells, const double* gx, const double* gw, int nqc,
                          const double* fx, const double* fw, int nqf, const int* px,
                          const int* py, int rbs, void* stream) {
  const int recdeg = face_degree + 1;
  if (nqc != recdeg + 1 || nqf != face_degree + 1 ||
      rbs != (recdeg + 1) * (recdeg + 2) / 2 || nqc > kMaxNodes || rbs > kMaxBasis)
    return -2;
  Tables tab = {};
  for (int q = 0; q < nqc; ++q) {
    tab.gx[q] = gx[q];
    tab.gw[q] = gw[q];
  }
  for (int q = 0; q < nqf; ++q) {
    tab.fx[q] = fx[q];
    tab.fw[q] = fw[q];
  }
  for (int b = 0; b < rbs; ++b) {
    tab.px[b] = px[b];
    tab.py[b] = py[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return dispatch<double>(cell_degree, face_degree, corners, bar, diam, meas, normals, fgeo,
                            out, n_cells, tab, s);
  return dispatch<float>(cell_degree, face_degree, corners, bar, diam, meas, normals, fgeo,
                         out, n_cells, tab, s);
}

const char* fused_assembly_error_string(int code) {
  if (code == -1) return "no kernel instantiated for this (cell_degree, face_degree)";
  if (code == -2) return "quadrature or basis tables of the wrong size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
