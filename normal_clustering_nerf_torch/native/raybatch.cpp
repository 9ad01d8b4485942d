// Host-side ray-batch sampler + prefetch queue.
//
// The port's own copy of the JAX package's native/raybatch.cpp, the same
// code: the reference feeds training with 16 torch DataLoader worker
// processes drawing numpy indices (reference: train_nerf.py:293-298,
// datasets/base.py:84-182); with `host_sampler` the host assembles
// gather-ready batches and streams them to the card. This library
// implements the reference's sampling strategies (uniform pixels, pixel
// triangles with optional dilation, 8x8 triangle patches —
// datasets/base.py:15-66) over a zero-copy view of the scene arrays, with
// a multi-threaded prefetch ring so batch assembly overlaps device
// compute.
//
// Exposed as a plain C ABI consumed via ctypes
// (normal_clustering_nerf_torch/datasets/native_sampler.py), which builds
// it with g++ into build/native/ at first use.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

// xoshiro256** — fast, seedable, reproducible across platforms
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed;
    for (int i = 0; i < 4; i++) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
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
  // unbiased bounded draw (Lemire)
  inline uint32_t bounded(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t l = (uint32_t)m;
    if (l < n) {
      uint32_t t = (~n + 1) % n;
      while (l < t) {
        m = (uint64_t)(uint32_t)next() * n;
        l = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

enum Strategy : int32_t {
  ALL_IMAGES = 0,
  SAME_IMAGE = 1,
  ALL_IMAGES_TRIANG = 2,
  SAME_IMAGE_TRIANG = 3,
  ALL_IMAGES_TRIANG_PATCH = 4,
  SAME_IMAGE_TRIANG_PATCH = 5,
};

struct SamplerConfig {
  int32_t strategy;
  int32_t batch_size;
  int32_t n_images;
  int32_t width;
  int32_t height;
  int32_t max_expand;   // triangle dilation (base.py:128-138)
  int32_t patch_size;   // 8 by default (base.py:35)
};

struct SceneView {
  const float* rgb;          // (n_images, H*W, 3)
  const float* depth;        // (n_images, H*W) or null
  const float* normals;      // (n_images, H*W, 3) or null
  const int32_t* semantics;  // (n_images, H*W) or null
};

struct Batch {
  std::vector<int32_t> img_idxs;
  std::vector<int32_t> pix_idxs;
  std::vector<float> rgb;
  std::vector<float> depth;
  std::vector<float> normals;
  std::vector<int32_t> semantics;
};

// --------------------------------------------------------- index sampling
void sample_indices(const SamplerConfig& cfg, Rng& rng,
                    std::vector<int32_t>& img_idxs,
                    std::vector<int32_t>& pix_idxs) {
  const int32_t B = cfg.batch_size;
  const int32_t W = cfg.width, H = cfg.height;
  const int32_t N = W * H;
  img_idxs.resize(B);
  pix_idxs.resize(B);

  auto fill_imgs = [&](int group, bool same) {
    if (same) {
      int32_t img = (int32_t)rng.bounded(cfg.n_images);
      for (int32_t i = 0; i < B; i++) img_idxs[i] = img;
    } else {
      for (int32_t g = 0; g < B / group; g++) {
        int32_t img = (int32_t)rng.bounded(cfg.n_images);
        for (int k = 0; k < group; k++) img_idxs[g * group + k] = img;
      }
    }
  };

  switch (cfg.strategy) {
    case ALL_IMAGES:
    case SAME_IMAGE: {
      fill_imgs(1, cfg.strategy == SAME_IMAGE);
      for (int32_t i = 0; i < B; i++) pix_idxs[i] = (int32_t)rng.bounded(N);
      break;
    }
    case ALL_IMAGES_TRIANG:
    case SAME_IMAGE_TRIANG: {
      // valid x1 corners live in the interior (base.py:27-33)
      const int32_t n_triang = B / 3;
      fill_imgs(3, cfg.strategy == SAME_IMAGE_TRIANG);
      const int32_t vw = W - 2, vh = H - 2;
      for (int32_t tIdx = 0; tIdx < n_triang; tIdx++) {
        int32_t v = (int32_t)rng.bounded(vw * vh);
        int32_t r = v / vw + 1, c = v % vw + 1;
        int32_t x1 = r * W + c;
        int32_t x2 = (r - 1) * W + c;
        int32_t x3 = r * W + (c - 1);
        if (cfg.max_expand > 0) {
          // dilation with the reference's bounds checks (base.py:128-138)
          int32_t e = cfg.max_expand;
          int32_t x1n = x1 + e * W;
          if (x1n < N) x1 = x1n;
          int32_t x2n = x2 - e * W;
          if (x2n >= 0) x2 = x2n;
          int32_t x3n = x3 - e;
          if (x3n / W == x3 / W && x3n >= 0) x3 = x3n;
        }
        pix_idxs[3 * tIdx] = x1;
        pix_idxs[3 * tIdx + 1] = x2;
        pix_idxs[3 * tIdx + 2] = x3;
      }
      break;
    }
    case ALL_IMAGES_TRIANG_PATCH:
    case SAME_IMAGE_TRIANG_PATCH: {
      const int32_t p = cfg.patch_size;
      const int32_t pa = p * p;
      const int32_t n_patches = B / pa;
      fill_imgs(pa, cfg.strategy == SAME_IMAGE_TRIANG_PATCH);
      const int32_t cw = W - p + 1, ch = H - p + 1;
      for (int32_t g = 0; g < n_patches; g++) {
        int32_t v = (int32_t)rng.bounded(cw * ch);
        int32_t corner = (v / cw) * W + (v % cw);
        for (int32_t dy = 0; dy < p; dy++)
          for (int32_t dx = 0; dx < p; dx++)
            pix_idxs[g * pa + dy * p + dx] = corner + dy * W + dx;
      }
      break;
    }
  }
}

void gather_batch(const SamplerConfig& cfg, const SceneView& scene,
                  Batch& out) {
  const int32_t B = cfg.batch_size;
  const int64_t N = (int64_t)cfg.width * cfg.height;
  out.rgb.resize((size_t)B * 3);
  if (scene.depth) out.depth.resize(B);
  if (scene.normals) out.normals.resize((size_t)B * 3);
  if (scene.semantics) out.semantics.resize(B);
  for (int32_t i = 0; i < B; i++) {
    const int64_t off = (int64_t)out.img_idxs[i] * N + out.pix_idxs[i];
    std::memcpy(&out.rgb[(size_t)i * 3], scene.rgb + off * 3,
                3 * sizeof(float));
    if (scene.depth) out.depth[i] = scene.depth[off];
    if (scene.normals)
      std::memcpy(&out.normals[(size_t)i * 3], scene.normals + off * 3,
                  3 * sizeof(float));
    if (scene.semantics) out.semantics[i] = scene.semantics[off];
  }
}

// ------------------------------------------------------------- prefetcher
struct Prefetcher {
  SamplerConfig cfg;
  SceneView scene;
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seq{0};
  size_t depth_cap;
  uint64_t seed;

  Prefetcher(SamplerConfig c, SceneView s, int n_threads, int queue_depth,
             uint64_t sd)
      : cfg(c), scene(s), depth_cap(queue_depth), seed(sd) {
    for (int t = 0; t < n_threads; t++) {
      workers.emplace_back([this, t] { worker_loop(t); });
    }
  }

  void worker_loop(int tid) {
    while (!stop.load()) {
      uint64_t my_seq = seq.fetch_add(1);
      // per-batch deterministic stream: seed ^ sequence number
      Rng rng(seed + my_seq * 0x9e3779b97f4a7c15ULL);
      auto* b = new Batch();
      sample_indices(cfg, rng, b->img_idxs, b->pix_idxs);
      gather_batch(cfg, scene, *b);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [this] { return ready.size() < depth_cap || stop; });
      if (stop) {
        delete b;
        return;
      }
      ready.push(b);
      cv_ready.notify_one();
    }
  }

  Batch* pop() {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [this] { return !ready.empty() || stop; });
    if (ready.empty()) return nullptr;
    Batch* b = ready.front();
    ready.pop();
    cv_space.notify_one();
    return b;
  }

  ~Prefetcher() {
    stop = true;
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& w : workers) w.join();
    std::unique_lock<std::mutex> lk(mu);
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }
};

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

void* rb_create(int32_t strategy, int32_t batch_size, int32_t n_images,
                int32_t width, int32_t height, int32_t max_expand,
                int32_t patch_size, const float* rgb, const float* depth,
                const float* normals, const int32_t* semantics,
                int32_t n_threads, int32_t queue_depth, uint64_t seed) {
  SamplerConfig cfg{strategy, batch_size, n_images, width,
                    height,   max_expand, patch_size};
  SceneView scene{rgb, depth, normals, semantics};
  return new Prefetcher(cfg, scene, n_threads, queue_depth, seed);
}

// Blocking pop of one prefetched batch into caller-provided buffers.
// Buffers for absent labels may be null. Returns 0 on success.
int32_t rb_next(void* handle, int32_t* img_idxs, int32_t* pix_idxs,
                float* rgb, float* depth, float* normals,
                int32_t* semantics) {
  auto* p = static_cast<Prefetcher*>(handle);
  Batch* b = p->pop();
  if (!b) return -1;
  const size_t B = b->img_idxs.size();
  std::memcpy(img_idxs, b->img_idxs.data(), B * sizeof(int32_t));
  std::memcpy(pix_idxs, b->pix_idxs.data(), B * sizeof(int32_t));
  std::memcpy(rgb, b->rgb.data(), B * 3 * sizeof(float));
  if (depth && !b->depth.empty())
    std::memcpy(depth, b->depth.data(), B * sizeof(float));
  if (normals && !b->normals.empty())
    std::memcpy(normals, b->normals.data(), B * 3 * sizeof(float));
  if (semantics && !b->semantics.empty())
    std::memcpy(semantics, b->semantics.data(), B * sizeof(int32_t));
  delete b;
  return 0;
}

void rb_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
