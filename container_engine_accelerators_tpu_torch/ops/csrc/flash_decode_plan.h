// The flash-decode kernel's plan, in plain C++ (no CUDA header), so that
// the host compiler alone can build and test it: how a cache row is held
// (16-byte chunks, lanes a key), how many query rows a CTA takes, and how
// many CTAs share each row block's keys.  flash_decode.cuh builds the
// kernel's templates from these; nothing else restates them.

#pragma once

namespace {

constexpr int kPasses = 2;       // a tile is kPasses passes of 32 / LPK keys
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 16;   // the largest cluster Hopper takes
constexpr int kCtasPerSm = 4;    // latency-bound CTAs: several share an SM

// A cache row in shared memory: D elements padded to whole 16-byte chunks
// (the padding is zero; a row of whole chunks has none).
constexpr int row_bytes(int D, int elem) { return (D * elem + 15) / 16 * 16; }

// Lanes per key for a padded row of `row_bytes`: one 16-byte chunk each, 4
// to 32 (f32 rows past 512 bytes: 32 lanes of 2 chunks).
constexpr int lanes_per_key(int row_bytes) {
  return row_bytes <= 64 ? 4 : row_bytes <= 128 ? 8 : row_bytes <= 256 ? 16 : 32;
}

// The most query rows a CTA takes for a row of `row_bytes`: 64 f32 of the
// accumulator a lane.  A group of G rows takes 1, 4 or this many.
constexpr int max_rows(int row_bytes, int elem) {
  return 64 / ((row_bytes > 512 ? 2 : 1) * (16 / elem));
}
constexpr int rows_per_cta(int G, int row_bytes, int elem) {
  return G == 1 ? 1 : G <= 4 ? 4 : max_rows(row_bytes, elem);
}

// The launch's plan: query rows a CTA takes, and the CTAs that share
// each row block's visible keys and form one cluster.  Only the shapes
// are known on the host (lengths stay on the device), so the grid depends
// on nothing else and a CUDA graph captures it.
struct Plan {
  int rows, splits;
};

// Splits: about kCtasPerSm CTAs on each of the `sms` multiprocessors (a
// CTA spends most of its time waiting on latency, so several share an
// SM), and no more than the cache has tiles.  At most 8 for one-row CTAs:
// 16 warps fill an SM's registers, and a cluster of 16 such CTAs needs 16
// free SMs of one GPC, which not every GPC of an H100 has; else
// kMaxSplits.  Rows: rows_per_cta, unless its row blocks are so few that
// even the widest clusters leave SMs idle (one KV head at batch 1): then
// one row a CTA, so that a group's rows spread over G times the CTAs
// (which read the same K/V, from L2 after the first).  Without TMA (tma
// false: rows not whole 16-byte chunks, or an unaligned cache) one row a
// CTA too: the plain-load copy is built for one-row CTAs only.
inline Plan make_plan(int B, int H, int KVH, int D, int elem, int L, int sms, bool tma) {
  const int G = H / KVH, rb = row_bytes(D, elem);
  auto groups = [&](int rows) {
    return static_cast<long long>(B) * KVH * ((G + rows - 1) / rows);
  };
  auto cap = [](int rows) { return rows == 1 ? 8 : kMaxSplits; };
  int rows = tma ? rows_per_cta(G, rb, elem) : 1;
  if (rows > 1 && groups(rows) * cap(rows) < sms) rows = 1;
  const long long keys = kPasses * 32 / lanes_per_key(rb);  // a tile
  long long splits = (static_cast<long long>(kCtasPerSm) * sms + groups(rows) - 1) / groups(rows);
  if (splits > cap(rows)) splits = cap(rows);
  if (splits > (L + keys - 1) / keys) splits = (L + keys - 1) / keys;
  return {rows, splits < 1 ? 1 : static_cast<int>(splits)};
}

}  // namespace
