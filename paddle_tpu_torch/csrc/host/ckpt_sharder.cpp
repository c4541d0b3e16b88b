// Parallel checkpoint shard writer/reader (upstream analogue: the fleet
// checkpoint sharding utilities under
// python/paddle/distributed/fleet/utils/ + the C++ save/load kernels in
// paddle/fluid/framework/io/).
//
// Host code: the port's own copy of the JAX package's
// csrc/ckpt_sharder.cpp, built by paddle_tpu_torch/utils/ckpt_native.py.
// Checkpoints are trees of host arrays (see
// paddle_tpu_torch/serialization.py). The npz container is single-stream and
// pays zip CRC per byte; here each shard file is written/read by its own
// thread as raw bytes — the manifest (JSON, python-side) records
// name -> (shard, offset, size, dtype, shape). No framing in the binary
// files, so reads are plain pread-style sequential fread into
// preallocated buffers.
//
// Error contract: returns 0 on success, or (index of the failing file
// + 1). Each thread touches only its own file, so the first error per
// file wins and no partial state is shared.

#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

namespace {

// one shard file = arrays [starts[f], starts[f+1]) written back-to-back
void write_one(const char* path, const void* const* ptrs,
               const unsigned long long* sizes, long long lo, long long hi,
               std::atomic<int>* err, int fidx) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) {
    err->store(fidx + 1);
    return;
  }
  for (long long i = lo; i < hi; ++i) {
    if (sizes[i] == 0) continue;
    if (std::fwrite(ptrs[i], 1, sizes[i], fp) != sizes[i]) {
      err->store(fidx + 1);
      std::fclose(fp);
      return;
    }
  }
  if (std::fclose(fp) != 0) err->store(fidx + 1);
}

void read_one(const char* path, void* const* ptrs,
              const unsigned long long* sizes, long long lo, long long hi,
              std::atomic<int>* err, int fidx) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    err->store(fidx + 1);
    return;
  }
  for (long long i = lo; i < hi; ++i) {
    if (sizes[i] == 0) continue;
    if (std::fread(ptrs[i], 1, sizes[i], fp) != sizes[i]) {
      err->store(fidx + 1);
      std::fclose(fp);
      return;
    }
  }
  std::fclose(fp);
}

}  // namespace

extern "C" {

int ckpt_write(const char** paths, int n_files, const long long* starts,
               const void* const* ptrs, const unsigned long long* sizes) {
  std::atomic<int> err{0};
  std::vector<std::thread> threads;
  threads.reserve(n_files);
  for (int f = 0; f < n_files; ++f)
    threads.emplace_back(write_one, paths[f], ptrs, sizes, starts[f],
                         starts[f + 1], &err, f);
  for (auto& t : threads) t.join();
  return err.load();
}

int ckpt_read(const char** paths, int n_files, const long long* starts,
              void* const* ptrs, const unsigned long long* sizes) {
  std::atomic<int> err{0};
  std::vector<std::thread> threads;
  threads.reserve(n_files);
  for (int f = 0; f < n_files; ++f)
    threads.emplace_back(read_one, paths[f], ptrs, sizes, starts[f],
                         starts[f + 1], &err, f);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
