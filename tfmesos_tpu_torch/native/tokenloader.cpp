// Native token-file gather for TokenFileDataset (train/data.py), a copy
// of the JAX package's tokenloader.cpp.  kernels/build.py:build_host
// compiles it with g++ at first use.
//
// The Python hot loop builds each batch as B slice-copies off a memmap plus
// a uint16/uint32 -> int32 convert — all on the GIL, serialized with the
// step dispatch.  This library does the same gather+convert in C++ (madvise
// read-ahead, no GIL) and can run it on a background thread so batch N+1
// assembles while step N runs: the input-pipeline half of the runtime the
// reference delegated to TF's C++ input ops (SURVEY §2.6), rebuilt for the
// flat-token-file format.
//
// Contract (mirrors the numpy path bit for bit): out[i, :] =
// int32(tokens[starts[i] : starts[i] + t1]) for each of the b windows.
// One in-flight async gather per handle; tl_wait joins it.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>

namespace {

struct Loader {
  const uint8_t *base = nullptr;  // mmap'd file
  int64_t file_bytes = 0;
  int64_t n_tokens = 0;
  int dtype_bytes = 0;  // 2 (uint16) or 4 (uint32)
  std::thread worker;
  std::atomic<bool> busy{false};
};

void gather(const Loader *ld, const int64_t *starts, int64_t b, int64_t t1,
            int32_t *out) {
  const int64_t db = ld->dtype_bytes;
  const long page = sysconf(_SC_PAGESIZE);
  // Hint ALL windows before copying any: the kernel reads ahead for the
  // later rows while the earlier ones convert (hinting row i just before
  // copying row i would overlap with nothing).  Harmless when cached.
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t *src = ld->base + starts[i] * db;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~(page - 1);
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(src + t1 * db);
    madvise(reinterpret_cast<void *>(a0), a1 - a0, MADV_WILLNEED);
  }
  for (int64_t i = 0; i < b; ++i) {
    const int64_t s = starts[i];
    const uint8_t *src = ld->base + s * db;
    int32_t *dst = out + i * t1;
    if (db == 2) {
      const uint16_t *p = reinterpret_cast<const uint16_t *>(src);
      for (int64_t j = 0; j < t1; ++j) dst[j] = static_cast<int32_t>(p[j]);
    } else {
      const uint32_t *p = reinterpret_cast<const uint32_t *>(src);
      for (int64_t j = 0; j < t1; ++j) dst[j] = static_cast<int32_t>(p[j]);
    }
  }
}

}  // namespace

extern "C" {

// Returns a handle (opaque pointer) or 0 on failure.
void *tl_open(const char *path, int dtype_bytes) {
  if (dtype_bytes != 2 && dtype_bytes != 4) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  void *base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);  // the mapping keeps the file alive
  if (base == MAP_FAILED) return nullptr;
  madvise(base, st.st_size, MADV_RANDOM);  // sampled windows, not a scan
  auto *ld = new Loader();
  ld->base = static_cast<const uint8_t *>(base);
  ld->file_bytes = st.st_size;
  ld->n_tokens = st.st_size / dtype_bytes;
  ld->dtype_bytes = dtype_bytes;
  return ld;
}

int64_t tl_n_tokens(void *handle) {
  return handle ? static_cast<Loader *>(handle)->n_tokens : -1;
}

// Synchronous gather: out must hold b*t1 int32s; every window must lie in
// [0, n_tokens - t1].  Returns 0 on success.
int tl_gather(void *handle, const int64_t *starts, int64_t b, int64_t t1,
              int32_t *out) {
  auto *ld = static_cast<Loader *>(handle);
  if (!ld || b <= 0 || t1 <= 0) return -1;
  for (int64_t i = 0; i < b; ++i)
    if (starts[i] < 0 || starts[i] + t1 > ld->n_tokens) return -2;
  gather(ld, starts, b, t1, out);
  return 0;
}

// Launch the same gather on a background thread.  starts/out must stay
// valid until tl_wait returns; one in-flight gather per handle.
int tl_gather_async(void *handle, const int64_t *starts, int64_t b,
                    int64_t t1, int32_t *out) {
  auto *ld = static_cast<Loader *>(handle);
  if (!ld || b <= 0 || t1 <= 0) return -1;
  if (ld->worker.joinable()) {
    // A finished-but-unjoined worker is still joinable; assigning over it
    // would std::terminate.  Only a gather actually mid-flight is an error.
    if (ld->busy.load()) return -3;
    ld->worker.join();
  }
  for (int64_t i = 0; i < b; ++i)
    if (starts[i] < 0 || starts[i] + t1 > ld->n_tokens) return -2;
  ld->busy.store(true);
  ld->worker = std::thread([ld, starts, b, t1, out] {
    gather(ld, starts, b, t1, out);
    ld->busy.store(false);
  });
  return 0;
}

// Join the in-flight gather (no-op when none).  Returns 0.
int tl_wait(void *handle) {
  auto *ld = static_cast<Loader *>(handle);
  if (!ld) return -1;
  if (ld->worker.joinable()) ld->worker.join();
  return 0;
}

void tl_close(void *handle) {
  auto *ld = static_cast<Loader *>(handle);
  if (!ld) return;
  if (ld->worker.joinable()) ld->worker.join();
  munmap(const_cast<uint8_t *>(ld->base), ld->file_bytes);
  delete ld;
}

}  // extern "C"
