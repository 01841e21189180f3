// The voxel-coordinate hash of the maps (ops/voxel_map.py::_mix64 and
// _check31), shared by csrc/knn5_plane_tiled.cu (its tile hash) and
// csrc/knn5_plane_hashed.cu (the hash slot and the voxels' verification
// hash of the hash and dense maps). uint32 arithmetic wraps as the plain
// version's masked int64 does, so every bit equals the plain version's,
// negative coordinates included (two's complement).
#pragma once

#include <stdint.h>

// murmur3's 32-bit finalizer (voxel_map._fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// voxel_map._mix64: the chained murmur mix of an int32 coordinate, the
// full uint32
__device__ __forceinline__ uint32_t mix3(int32_t x, int32_t y, int32_t z) {
  uint32_t h = fmix32((uint32_t)x * 0x9E3779B1u);
  h = fmix32(h ^ ((uint32_t)y * 0x85EBCA77u));
  return fmix32(h ^ ((uint32_t)z * 0xC2B2AE3Du));
}

// voxel_map._check31: its low 31 bits (never the EMPTY_CHECK sentinel)
__device__ __forceinline__ int32_t check31(int32_t x, int32_t y, int32_t z) {
  return (int32_t)(mix3(x, y, z) & 0x7FFFFFFFu);
}
