// The host side of a launch, shared by every source of csrc/: what a
// launch needs from the CUDA runtime and libcuda is done once and kept, so a
// launch costs the host its own call and little else.
//
//   * smem_limit_once(kernel, bytes): cudaFuncSetAttribute(
//     MaxDynamicSharedMemorySize) once per kernel, device and larger size
//     (a smaller size is already allowed), not on every launch. Besides its
//     cost, the attribute call is no stream operation: a launch that made
//     it could not be captured into a CUDA graph.
//   * encode_map(...): cuTensorMapEncodeTiled, reached once through
//     cudaGetDriverEntryPoint (nothing links libcuda), every encoding
//     counted (msid_tensor_map_encodes, exported by each library).
//   * cached_map(...): the same through a bounded table keyed by every
//     argument of the encoding. A map is a function of its pointer, dims,
//     strides, box, swizzle and L2 promotion alone, so a hit is never stale,
//     even where the caching allocator has handed the address to a new
//     tensor; a collision only evicts.
// Everything but the exported counter is inside an anonymous namespace:
// each library keeps its own.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kMaxRank = 5;
constexpr int kMapSlots = 256;
constexpr int kSmemSlots = 64;
constexpr size_t kDefaultSmem = 48 * 1024;   // allowed without the attribute

std::atomic<long long> g_encodes{0};

// cuTensorMapEncodeTiled, or null when libcuda does not export it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled tensor map over `ptr` with element strides 1, no interleave and
// no fill value (out-of-bounds elements load as zeros, stores drop them).
CUresult encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                    CUtensorMapL2promotion l2) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  if (rank < 1 || rank > kMaxRank) return CUDA_ERROR_INVALID_VALUE;
  const cuuint32_t elem[kMaxRank] = {1, 1, 1, 1, 1};
  g_encodes.fetch_add(1, std::memory_order_relaxed);
  return encode(map, dtype, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct MapKey {   // every argument of encode_map; zeroed first, so memcmp is exact
  const void* ptr;
  cuuint64_t dims[kMaxRank];
  cuuint64_t strides[kMaxRank - 1];
  cuuint32_t box[kMaxRank];
  int dtype, rank, swizzle, l2;
};

struct MapSlot {
  CUtensorMap map;
  MapKey key;
  bool used;
};

MapSlot g_maps[kMapSlots];
std::mutex g_maps_mutex;

// encode_map through the table: the map of an earlier call with the same
// arguments, else a new encoding that takes the slot of the key's hash.
CUresult cached_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                    CUtensorMapL2promotion l2) {
  if (rank < 1 || rank > kMaxRank) return CUDA_ERROR_INVALID_VALUE;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = ptr;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  key.dtype = (int)dtype;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.l2 = (int)l2;
  uint64_t hash = 1469598103934665603ull;   // FNV-1a over the key's bytes
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof key; ++i) hash = (hash ^ bytes[i]) * 1099511628211ull;
  MapSlot& slot = g_maps[hash % kMapSlots];
  {
    std::lock_guard<std::mutex> lock(g_maps_mutex);
    if (slot.used && memcmp(&slot.key, &key, sizeof key) == 0) {
      *map = slot.map;
      return CUDA_SUCCESS;
    }
  }
  const CUresult res = encode_map(map, dtype, rank, ptr, dims, strides, box, swizzle, l2);
  if (res == CUDA_SUCCESS) {
    std::lock_guard<std::mutex> lock(g_maps_mutex);
    slot.map = *map;
    slot.key = key;
    slot.used = true;
  }
  return res;
}

struct SmemLimit {
  const void* kernel;
  int device;
  size_t bytes;
};

SmemLimit g_limits[kSmemSlots];
int g_limits_used = 0;
std::mutex g_limits_mutex;

// Allow `kernel` `bytes` of dynamic shared memory on the current device:
// the attribute is set the first time a size above 48 KB and above what
// was set before is asked for, and never again for that size.
cudaError_t smem_limit_once(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_limits_mutex);
  int i = 0;
  while (i < g_limits_used && (g_limits[i].kernel != kernel || g_limits[i].device != device))
    ++i;
  if (i < g_limits_used && g_limits[i].bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (i < g_limits_used) {
    g_limits[i].bytes = bytes;
  } else if (g_limits_used < kSmemSlots) {   // a full table sets it on every launch
    g_limits[g_limits_used++] = SmemLimit{kernel, device, bytes};
  }
  return cudaSuccess;
}

}  // namespace

// Tensor maps this library has encoded so far (cached_map's hits are not
// encodings).
extern "C" long long msid_tensor_map_encodes() {
  return g_encodes.load(std::memory_order_relaxed);
}
