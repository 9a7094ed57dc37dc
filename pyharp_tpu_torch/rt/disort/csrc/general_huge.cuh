// The pieces of K4's bodies at N > 32 that stage1_general_huge.cu (N =
// 33..64) and stage1_general_global.cu (N > 64) share: the addressing of a
// launch over several azimuthal modes, and the Jacobi sweeps with lane t of
// an element's warp on the rows t + 32 h, h < R (R = 2 in the huge body, X
// and Y in shared memory; R = 3..8 in the global body, in global scratch).
//
// The modes.  A radiance solve runs K4 at every mode m = 1..nstr-1 on the
// same (layer, column) elements; only the phase tables, lam0 = Lam_l^m(mu0)
// and m differ.  One launch takes them all (kernels.stage1_general_modes):
// its elements run over (mode, layer, column), mode-major, so that the warps
// of a mode's elements read its tables together; each element takes its
// mode's tables from a device array of table pointers, its m (the parity
// split and the beam prefactor) from the same array, its lam0 from an
// (nm, G, B) tensor, and writes its outputs into the (N, N, L, nm, B) and
// (N, L, nm, B) layout in which the radiances fold the modes into the
// batch axis as a view.  The per-mode entry is the launch over one mode.
//
// The sweeps.  A rotation (p, q) is a chain: a_pq by a shuffle from row
// q's lane, the rotation's three quotients and two square roots, row
// q + 1's new a_rp, and the shuffle of it that is the next rotation's
// a_pq.  The rest of a rotation is row work off that chain: every other
// row's a_rp and slot (r, q) of A, and every row's y_rq.  So a rotation
// here
//  - takes a_qq by a shuffle from the diagonal of row q's lane, loaded when
//    its p loop began (no rotation of a p loop writes the diagonal);
//  - loads its slots (r, q) of A and y_rq right after the barrier that
//    ordered the previous rotation's stores, ahead of the rotation that
//    hides their latency (each slot was last written at least one
//    rotation before, so nothing written after the barrier is read), at
//    addresses advanced from the previous rotation's;
//  - runs the rotation straight through on the fast paths (`quotient`,
//    `root`), row q + 1's new a_rp and its shuffle with it, the previous
//    rotation's y_rq updates beside them (Y's rows are a lane's own, so
//    they need no barrier), and redoes the rotation with `/` and sqrtf in
//    a branch that the range checks seldom take;
//  - then forms every row's new a_rp and a_rq by selects, a row p or q, or
//    a row past n, keeping its a_rp.  With DUMP (X in shared memory) every
//    row stores its a_rq, those rows into X's column n, which the sweeps
//    never read: as a predicated store ptxas made it a branch, which cost
//    12% at N = 64.  Without (X in global scratch, where the extra stores
//    cost sectors) only the rows that update a slot store.
// Every value is formed by the operations of the plain version
// (jacobi._rotate) in its order, so the bits are jacobi_eigh's;
// tests/test_torch_huge_k4.py and tests/test_torch_global_k4.py model the
// schedule lane by lane.
#pragma once

#include "general.cuh"

namespace {

// The modes of a launch: nm of them; `tabs` holds their tables' device
// pointers, then their m, nm 64-bit words each; mode i's lam0 is (G, B) at
// lam0 + i G B.  The per-mode entry passes nm = 1 and no `tabs`, its
// tables and m apart.
struct K4Modes {
  int64_t nm;
  int64_t G;
  const long long* tabs;
};

// Element ef of a launch over nm L B elements, mode-major: its mode i, the
// inputs' element e = layer B + b (every mode reads the same ssa, pmom,
// dtau, mur, fbeam), the outputs' element o = (layer nm + i) B + b at
// stride os = nm L B between their leading indices, and its mode's tables,
// m and lam0.
struct K4Element {
  int64_t e, layer, b, o, os;
  int mode;
  const float* tab;
  const float* lam0;
  __device__ K4Element(int64_t ef, int64_t lb, int64_t B, const K4Modes& M,
                       const float* tab0, int mode0, const float* lam0_in) {
    const int64_t i = ef / lb;
    e = ef - i * lb;
    layer = e / B;
    b = e - layer * B;
    o = (layer * M.nm + i) * B + b;
    os = lb * M.nm;
    tab = M.tabs ? reinterpret_cast<const float*>(M.tabs[i]) : tab0;
    mode = M.tabs ? static_cast<int>(M.tabs[M.nm + i]) : mode0;
    lam0 = lam0_in ? lam0_in + i * M.G * B : lam0_in;
  }
};

// a[h] for a warp-uniform h (a[0] for h past R), by selects.
template <int R>
__device__ __forceinline__ float pick(const float (&a)[R], int h) {
  float v = a[0];
#pragma unroll
  for (int k = 1; k < R; ++k) v = h == k ? a[k] : v;
  return v;
}

// rotation_checked with its fast path straight through, and the next
// rotation's a_pq: row q + 1's new a_rp, c a_rp - s a_rq from its lane's
// `arp` and `arq`, shuffled from lane `lane`.  The fast path and the
// shuffle are formed whatever the range; where the checks fail (a rare
// branch, on a vote so that the compiler sees it warp-uniform) the
// rotation is formed again by `/` and sqrtf from the same tau, and so is
// the shuffle.  So c, s and the new diagonal are rotation_checked's, bit
// for bit, and the next a_pq leaves with the rotation's last
// instructions, not after the row work.
__device__ __forceinline__ float rotation_straight(float app, float apq,
                                                   float aqq, float arp,
                                                   float arq, int lane,
                                                   float& c, float& s,
                                                   float& new_pp,
                                                   float& new_qq) {
  const bool small = fabsf(apq) <= 1.17549435e-35f;   // float32 tiny * 1e3
  const float denom = small ? 1.0f : 2.0f * apq;
  const float num = aqq - app;
  const bool ok = in_range(num) && in_range(denom);
  const float tq = quotient(num, denom);
  rotation_from<true>(tq, small, app, apq, aqq, c, s, new_pp, new_qq);
  float next = __shfl_sync(kBigFull, c * arp - s * arq, lane);
  if (!__all_sync(kBigFull, ok && fabsf(tq) <= 0x1p30f)) {
    const float tau = ok ? tq : num / denom;
    rotation_from<false>(tau, small, app, apq, aqq, c, s, new_pp, new_qq);
    next = __shfl_sync(kBigFull, c * arp - s * arq, lane);
  }
  return next;
}

// Marks of the sweeps' two parts in a build with -DPYHARP_BIG_PROFILE
// (phases 2 and 3 of the bodies' BIG_PROF_MARK): the chain up to the next
// a_pq's shuffle, then the row work and the barrier.  The marks split the
// rotation's straight-line code, so the marked build runs the two parts
// one after the other.
#ifdef PYHARP_BIG_PROFILE
#define K4_SWEEP_MARK(k) BIG_PROF_MARK(k)
#else
#define K4_SWEEP_MARK(k) do { } while (0)
#endif

// The sweeps of an element on its warp, rotation by rotation in the cyclic
// order of n (n <= 32 R), lane t on rows t + 32 h.  Entry (r, c) of A at
// X[max][min], Y's rows by rows, both at row stride ld.  At a fixed p the
// lane carries a_rp, y_rp, the new a_rr and the diagonal a_rr of each of its
// rows in registers through the q loop, and stores a_rp, y_rp and the new
// diagonal when it ends.
template <int R, bool DUMP>
__device__ __forceinline__ void sweeps_rows(float* X, float* Y, int ld, int n,
                                            int sweeps, int t) {
  auto slot = [ld](int r, int c) { return r > c ? r * ld + c : c * ld + r; };
  // where a row that updates no slot stores its value: X's column n of the
  // row (of row n - 1 past n), which the sweeps never read and the steps
  // after them write before they read
  int dump[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int r = t + 32 * h;
    dump[h] = (r < n ? r : n - 1) * ld + n;
  }
  for (int it = 0; it < sweeps; ++it) {
    for (int p = 0; p + 1 < n; ++p) {
      float arp[R];
      float yrp[R];
      float dq[R];                     // the row's new a_rr, from (p, r)
      float dg[R];                     // the row's a_rr as the loop began
      float vp[R];                     // y_rq of the previous rotation
      int xa[R];                       // slot (r, q) of A, advanced with q
      int ya[R];                       // y_r,q-1's place in Y
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int r = t + 32 * h;
        const bool live = h + 1 < R || r < n;   // n > 32 (R - 1)
        arp[h] = live && r != p ? X[slot(r, p)] : 0.0f;
        yrp[h] = live ? Y[r * ld + p] : 0.0f;
        dg[h] = live ? X[r * ld + r] : 0.0f;
        dq[h] = 0.0f;
        vp[h] = 0.0f;
        xa[h] = slot(r, p + 1);
        ya[h] = r * ld + p;
      }
      float app = X[p * ld + p];
      float apq = __shfl_sync(kBigFull, pick(arp, (p + 1) >> 5), (p + 1) & 31);
      // the previous rotation's c and s: at q = p + 1 the identity, whose
      // y update leaves y_rp as it is (its store to Y[r][p], which no
      // rotation of this p reads, is overwritten when the loop ends)
      float cp = 1.0f;
      float sp = 0.0f;
      for (int q = p + 1; q < n; ++q) {
        float arq[R];
        float vrq[R];
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int r = t + 32 * h;
          const bool live = h + 1 < R || r < n;
          arq[h] = live ? X[xa[h]] : 0.0f;
          vrq[h] = live ? Y[ya[h] + 1] : 0.0f;
        }
        const float aqq = __shfl_sync(kBigFull, pick(dg, q >> 5), q & 31);
        // the previous rotation's y_rq, beside this rotation's chain
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int r = t + 32 * h;
          const float y = yrp[h];
          if (h + 1 < R || r < n) Y[ya[h]] = sp * y + cp * vp[h];
          yrp[h] = cp * y - sp * vp[h];
          ya[h] += 1;
        }
        float c, s, new_pp, new_qq;
        const int hn = (q + 1) >> 5;   // row q + 1: the next a_pq
        apq = rotation_straight(app, apq, aqq, pick(arp, hn), pick(arq, hn),
                                (q + 1) & 31, c, s, new_pp, new_qq);
        K4_SWEEP_MARK(2);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int r = t + 32 * h;
          const bool gen = (h + 1 < R || r < n) && r != p && r != q;
          const float nrp = c * arp[h] - s * arq[h];
          const float nrq = s * arp[h] + c * arq[h];
          if (DUMP) {
            X[gen ? xa[h] : dump[h]] = nrq;
          } else if (gen) {
            X[xa[h]] = nrq;
          }
          arp[h] = gen ? nrp : (r == q ? 0.0f : arp[h]);
          dq[h] = r == q ? new_qq : dq[h];
          vp[h] = vrq[h];
          xa[h] += q < r ? 1 : ld;     // slot (r, q + 1)
        }
        cp = c;
        sp = s;
        app = new_pp;
        __syncwarp();
        K4_SWEEP_MARK(3);
      }
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int r = t + 32 * h;
        if (h + 1 == R && r >= n) continue;
        const float y = yrp[h];
        Y[ya[h]] = sp * y + cp * vp[h];
        yrp[h] = cp * y - sp * vp[h];
        if (r == p) {
          X[p * ld + p] = app;
        } else {
          X[slot(r, p)] = arp[h];
        }
        if (r > p) X[r * ld + r] = dq[h];
        Y[r * ld + p] = yrp[h];
      }
      __syncwarp();
    }
  }
}

}  // namespace
