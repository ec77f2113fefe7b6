// The plumbing of a ring of frames in shared memory, shared by the decode's
// ring kernels (B, C, M, Q: csrc/decode_ring.cuh) and the loss's (U, V,
// W, X: csrc/logz_ring.cu). A producer lane bulk-copies the rows of frames ahead
// into `ring` slots, one mbarrier `full` a slot counting the bytes; the
// consumers wait on a slot's `full` at the phase their Cursor gives. The
// block-wide barrier of each frame is the slots' `empty`: a slot is
// refilled only after the barrier of the last frame whose threads read it,
// fenced against the async proxy.

#pragma once

#include "lstm_persistent.cuh"

namespace {

constexpr int RING_MAX = 16;

// lane 0 of the producer warp: frame u's slot of `bytes` from the pieces
// (src, bytes) given, after the reads of its last frame (fenced against the
// async proxy where the slot was filled before)
__device__ __forceinline__ void fill(uint64_t* full, unsigned char* slot,
                                     unsigned bytes, bool refill,
                                     const void* a, unsigned na,
                                     const void* b = nullptr, unsigned nb = 0,
                                     const void* c = nullptr,
                                     unsigned nc = 0) {
    if (refill) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(full, bytes);
    bulk_copy(slot, a, na, full);
    if (nb) bulk_copy(slot + na, b, nb, full);
    if (nc) bulk_copy(slot + na + nb, c, nc, full);
}

// slot and phase of the next frame's row, advanced a frame at a time
struct Cursor {
    int slot, phase, ring;
    __device__ __forceinline__ void next() {
        if (++slot == ring) { slot = 0; phase ^= 1; }
    }
};

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
