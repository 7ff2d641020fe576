// Host-side native planner for the design compiler.
//
// The reference implements its whole engine in C++
// (include/myfm/FMTrainer.hpp); in this rebuild all
// *compute* lives on-device (JAX/XLA/Pallas), and the only host-side
// hot path is design-matrix compilation: partitioning the columns of a
// CSC design matrix into row-disjoint "colors" (see
// myfm_tpu/design.py:greedy_color).  That pass is inherently sequential
// (each column's color depends on counters updated by every previous
// column), so it cannot be vectorized with numpy — this translation
// unit provides the O(nnz) C++ implementation, loaded via ctypes.
//
// Build: g++ -O3 -shared -fPIC planner.cc -o _planner.so   (see
// myfm_tpu/_native/__init__.py, which builds lazily on first import).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy row-disjoint coloring of CSC columns.
//
//   indptr  : [n_cols + 1] int64 column pointers
//   indices : [nnz]        int32 row indices
//   assign  : [n_cols]     int32 output color per column
//
// Invariant (same as the numpy fallback): c[r] is the smallest color
// safe for any future column touching row r.  A column's color is
// max(c[rows]); afterwards c[rows] is raised to color + 1, so columns
// sharing a row always land in different colors.
void myfm_greedy_color(int64_t n_rows, int64_t n_cols,
                       const int64_t* indptr, const int32_t* indices,
                       int32_t* assign) {
  std::vector<int32_t> c(static_cast<size_t>(n_rows), 0);
  for (int64_t f = 0; f < n_cols; ++f) {
    int32_t col = 0;
    const int64_t begin = indptr[f];
    const int64_t end = indptr[f + 1];
    for (int64_t p = begin; p < end; ++p) {
      col = std::max(col, c[indices[p]]);
    }
    assign[f] = col;
    const int32_t next = col + 1;
    for (int64_t p = begin; p < end; ++p) {
      int32_t& cr = c[indices[p]];
      cr = std::max(cr, next);
    }
  }
}

// Exact padded row count of the greedy (T-row, <=S-entity) packing —
// the inner loop of design_categorical.choose_tiling.
int64_t myfm_packed_rows(int64_t n_entities, const int64_t* counts,
                         int64_t T, int64_t S) {
  int64_t total = 0, row_fill = 0, ent_fill = 0;
  for (int64_t u = 0; u < n_entities; ++u) {
    int64_t c = counts[u];
    if (c == 0) continue;
    int64_t taken = 0;
    while (taken < c) {
      if (row_fill >= T || ent_fill >= S) {
        total += T;
        row_fill = 0;
        ent_fill = 0;
      }
      int64_t take = std::min(c - taken, T - row_fill);
      taken += take;
      row_fill += take;
      ent_fill += 1;
    }
  }
  if (row_fill) total += T;
  return total;
}

// Greedy tile packing (design_categorical._pack_tiles).  Caller sizes
// the outputs from myfm_packed_rows(+one trailing pad tile):
//   n_out = packed_rows + T.
// Inputs: order[n] (row indices sorted by entity), counts[n_entities].
// Outputs (lengths): src/slot/ent [n_out]; ent_slots [n_out/T * S].
// Pads: src = n, slot = S, ent = n_entities, ent_slots = n_entities.
void myfm_pack_tiles(int64_t n, int64_t n_entities, const int64_t* order,
                     const int64_t* counts, int64_t T, int64_t S,
                     int64_t n_out, int32_t* src, int32_t* slot,
                     int32_t* ent, int32_t* ent_slots) {
  const int64_t K = n_out / T;
  for (int64_t i = 0; i < n_out; ++i) {
    src[i] = static_cast<int32_t>(n);
    slot[i] = static_cast<int32_t>(S);
    ent[i] = static_cast<int32_t>(n_entities);
  }
  for (int64_t i = 0; i < K * S; ++i)
    ent_slots[i] = static_cast<int32_t>(n_entities);

  int64_t pos = 0;       // cursor into `order`
  int64_t tile = 0;      // current tile
  int64_t row_fill = 0;  // rows used in current tile
  int64_t ent_fill = 0;  // slots used in current tile
  for (int64_t u = 0; u < n_entities; ++u) {
    int64_t c = counts[u];
    if (c == 0) continue;
    int64_t taken = 0;
    while (taken < c) {
      if (row_fill >= T || ent_fill >= S) {
        ++tile;
        row_fill = 0;
        ent_fill = 0;
      }
      int64_t take = std::min(c - taken, T - row_fill);
      const int64_t base = tile * T + row_fill;
      for (int64_t j = 0; j < take; ++j) {
        src[base + j] = static_cast<int32_t>(order[pos + j]);
        slot[base + j] = static_cast<int32_t>(ent_fill);
        ent[base + j] = static_cast<int32_t>(u);
      }
      ent_slots[tile * S + ent_fill] = static_cast<int32_t>(u);
      pos += take;
      taken += take;
      row_fill += take;
      ent_fill += 1;
    }
  }
}

}  // extern "C"
