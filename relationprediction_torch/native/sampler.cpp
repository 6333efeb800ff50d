// Native neighborhood-expansion edge sampler.
//
// Exact algorithm of the reference's sample_edge_neighborhood
// (code/train.py:161-198): repeatedly draw a 'seen' vertex with probability
// proportional to its remaining unpicked-edge budget, then a uniformly
// random unpicked incident edge of that vertex; mark both endpoints seen.
//
// The reference's python loop renormalizes an O(V) categorical every step
// (~seconds per 30k-edge batch on FB15k-237); here a Fenwick tree gives
// O(log V) weighted draws and the whole batch samples in milliseconds.
//
// Distribution is identical to the reference; the RNG stream is xoshiro256**
// seeded by the caller (deterministic per seed, not bit-matched to numpy).
//
// Build: relationprediction_torch/native/__init__.py runs
// g++ -O3 -shared -fPIC into build/torch_kernels/ at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Xoshiro256ss {
  uint64_t s[4];
  explicit Xoshiro256ss(uint64_t seed) {
    // splitmix64 initialization
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

// Fenwick (binary indexed) tree over non-negative f64 weights supporting
// point update and inverse-CDF sampling in O(log n).
class Fenwick {
 public:
  explicit Fenwick(int64_t n) : n_(n), tree_(n + 1, 0.0) {}

  void add(int64_t i, double delta) {
    for (int64_t j = i + 1; j <= n_; j += j & (-j)) tree_[j] += delta;
  }

  double total() const {
    double s = 0;
    for (int64_t j = n_; j > 0; j -= j & (-j)) s += tree_[j];
    return s;
  }

  // Largest index i such that prefix_sum(i) <= u; returns the bucket
  // containing mass u. Assumes 0 <= u < total().
  int64_t sample(double u) const {
    int64_t pos = 0;
    int64_t bit = 1;
    while ((bit << 1) <= n_) bit <<= 1;
    for (; bit != 0; bit >>= 1) {
      int64_t next = pos + bit;
      if (next <= n_ && tree_[next] <= u) {
        pos = next;
        u -= tree_[next];
      }
    }
    return pos;  // 0-based index
  }

 private:
  int64_t n_;
  std::vector<double> tree_;
};

}  // namespace

extern "C" {

// CSR adjacency over undirected incidence (see sampling.AdjacencyIndex):
//   sorted_edges[offsets[v]..offsets[v+1]) = edge ids incident to v
//   sorted_others[...] = the opposite endpoint of each such edge
// Returns 0 on success.
int sample_edge_neighborhood(
    const int32_t* sorted_edges, const int32_t* sorted_others,
    const int64_t* offsets, const int64_t* degrees,
    int64_t n_vertices, int64_t n_edges, int64_t sample_size,
    uint64_t seed, int32_t* out_edges) {
  if (sample_size > n_edges) return 1;

  Xoshiro256ss rng(seed);
  Fenwick weights(n_vertices);           // sample_counts * seen
  std::vector<double> sample_counts(n_vertices);
  std::vector<uint8_t> seen(n_vertices, 0);
  std::vector<uint8_t> picked(n_edges, 0);
  // Fenwick over sample_counts for the cold-start uniform draw over
  // vertices with remaining budget (train.py:169-171: weights = 1 for
  // sample_counts > 0). Uses weight 1 per eligible vertex.
  Fenwick cold(n_vertices);
  std::vector<uint8_t> cold_active(n_vertices, 0);
  for (int64_t v = 0; v < n_vertices; ++v) {
    sample_counts[v] = static_cast<double>(degrees[v]);
    if (degrees[v] > 0) {
      cold.add(v, 1.0);
      cold_active[v] = 1;
    }
  }

  auto decrement = [&](int64_t v) {
    sample_counts[v] -= 1.0;
    if (seen[v]) weights.add(v, -1.0);
    if (sample_counts[v] <= 0.0 && cold_active[v]) {
      cold.add(v, -1.0);
      cold_active[v] = 0;
    }
  };
  auto mark_seen = [&](int64_t v) {
    if (!seen[v]) {
      seen[v] = 1;
      if (sample_counts[v] > 0.0) weights.add(v, sample_counts[v]);
    }
  };

  for (int64_t i = 0; i < sample_size; ++i) {
    double total = weights.total();
    int64_t chosen;
    if (total <= 0.0) {
      double ct = cold.total();
      if (ct <= 0.0) return 2;  // no vertex with remaining budget
      chosen = cold.sample(rng.uniform() * ct);
    } else {
      chosen = weights.sample(rng.uniform() * total);
    }
    mark_seen(chosen);

    int64_t begin = offsets[chosen], end = offsets[chosen + 1];
    int64_t deg = end - begin;
    // Rejection-sample an unpicked incident edge (train.py:181-187).
    int64_t edge_id, other;
    do {
      int64_t j = begin + static_cast<int64_t>(rng.below(deg));
      edge_id = sorted_edges[j];
      other = sorted_others[j];
    } while (picked[edge_id]);

    out_edges[i] = static_cast<int32_t>(edge_id);
    picked[edge_id] = 1;
    decrement(chosen);
    decrement(other);
    mark_seen(other);
  }
  return 0;
}

// Vectorized negative sampling (auxilliaries.py:13-33 semantics): tile the
// batch (rate+1)x and corrupt subject/object with a fair coin + uniform
// entity. Runs in C++ so the host pipeline never blocks the device.
void negative_sample(const int32_t* triples, int64_t n, int64_t rate,
                     int64_t n_entities, uint64_t seed,
                     int32_t* out_triples, float* out_labels) {
  Xoshiro256ss rng(seed);
  for (int64_t c = 0; c < rate + 1; ++c) {
    std::memcpy(out_triples + c * n * 3, triples,
                sizeof(int32_t) * n * 3);
  }
  for (int64_t i = 0; i < n; ++i) out_labels[i] = 1.0f;
  for (int64_t i = n; i < n * (rate + 1); ++i) {
    out_labels[i] = 0.0f;
    int32_t value = static_cast<int32_t>(rng.below(n_entities));
    if (rng.next() & 1) {
      out_triples[i * 3 + 2] = value;  // corrupt object
    } else {
      out_triples[i * 3 + 0] = value;  // corrupt subject
    }
  }
}

}  // extern "C"
