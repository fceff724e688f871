// Kernel B7 for Hopper (sm_90a): one saga round over the [G, M]
// SagaTable, its committed and exhausted tallies booked in the same
// launch. Replaces hypervisor_tpu/kernels/wave_pallas.py
// saga_tick_block_pallas (_saga_tick_kernel). Plain C entry point,
// bound with ctypes by hypervisor_tpu_torch/kernels/saga.py; the table
// is updated in place on the caller's stream and the entry returns
// cudaGetLastError().
//
// Bound by bytes (about 100 a saga) and, at the default 8,192 sagas, by
// the launch. One thread owns one saga row: with M a multiple of 16
// (at most 64) the step, retry and undo rows come in and go out as
// 16-byte vectors held in registers; otherwise the thread walks the row
// in device memory byte by byte. The round's two tallies, which the
// host used to book with about fourteen device ops of its own, are
// counted here: each warp ballots its committed and exhausted sagas and
// its first lane adds the counts to the metrics counter rows with one
// unsigned atomic each (wrapping at 2^32, as the u32 column does); a
// block sum in shared memory first timed slower. Every lane stays in
// the kernel to the ballot, so the ragged last warp is predicated, not
// returned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Step and saga codes (hypervisor_tpu_torch/ops/saga_ops.py).
constexpr int STEP_PENDING = 0;
constexpr int STEP_COMMITTED = 2;
constexpr int STEP_COMPENSATED = 4;
constexpr int STEP_COMPENSATION_FAILED = 5;
constexpr int STEP_FAILED = 6;
constexpr int SAGA_RUNNING = 0;
constexpr int SAGA_COMPENSATING = 1;
constexpr int SAGA_COMPLETED = 2;
constexpr int SAGA_ESCALATED = 4;
// Bits of the packed outcome byte (ops/saga_ops.py OUT_*).
constexpr unsigned OUT_EXEC_SUCCESS = 1;
constexpr unsigned OUT_UNDO_SUCCESS = 2;
constexpr unsigned OUT_EXEC_ATTEMPTED = 4;
constexpr unsigned OUT_UNDO_ATTEMPTED = 8;
constexpr int VEC_MAX_M = 64;
// 64-thread blocks: 128 blocks at the default 8,192 sagas, one an SM
// for most SMs; 128-thread blocks timed the same (PERF.md).
constexpr int THREADS = 64;

struct RowResult {
  int8_t saga_state;
  int cursor;
  bool committed, exhausted;
};

// The round for one saga, on its row (registers or device memory).
__device__ __forceinline__ RowResult tick_row(int8_t* step, int8_t* retries,
                                              const uint8_t* undo, int M, int8_t saga_state,
                                              int n_steps, int cursor, unsigned oc) {
  const bool exec_success = oc & OUT_EXEC_SUCCESS;
  const bool undo_success = oc & OUT_UNDO_SUCCESS;
  const bool exec_attempted = oc & OUT_EXEC_ATTEMPTED;
  const bool undo_attempted = oc & OUT_UNDO_ATTEMPTED;
  const bool running = saga_state == SAGA_RUNNING;
  // Read before the forward phase writes the state: a saga that flips
  // to COMPENSATING this round waits for its undo outcomes.
  const bool compensating = saga_state == SAGA_COMPENSATING;

  // Forward: book the cursor step (clipped for the gather, stored raw).
  const int cur = cursor < 0 ? 0 : (cursor > M - 1 ? M - 1 : cursor);
  const int8_t cur_state = step[cur];
  const int8_t cur_retries = retries[cur];
  const bool attempt = running && cursor < n_steps && cur_state == STEP_PENDING && exec_attempted;
  const bool committed = attempt && exec_success;
  const bool exhausted = attempt && !exec_success && cur_retries <= 0;
  const bool retrying = attempt && !exec_success && cur_retries > 0;
  step[cur] = committed ? STEP_COMMITTED : (exhausted ? STEP_FAILED : cur_state);
  retries[cur] = static_cast<int8_t>(cur_retries - (retrying ? 1 : 0));
  const int next = committed ? static_cast<int>(static_cast<unsigned>(cursor) + 1u) : cursor;
  const bool finished = running && next >= n_steps && n_steps > 0;
  int8_t state = exhausted ? SAGA_COMPENSATING : (finished ? SAGA_COMPLETED : saga_state);

  // Compensation: the highest COMMITTED column over all M, after the
  // forward write.
  int target = -1;
  for (int c = 0; c < M; ++c) {
    if (step[c] == STEP_COMMITTED) target = c;
  }
  if (compensating && target >= 0 && undo_attempted) {
    const bool undo_ok = undo[target] != 0 && undo_success;
    step[target] = undo_ok ? STEP_COMPENSATED : STEP_COMPENSATION_FAILED;
  }

  // Settle on the row after the compensation write.
  bool still_committed = false, any_comp_failed = false;
  for (int c = 0; c < M; ++c) {
    still_committed |= step[c] == STEP_COMMITTED;
    any_comp_failed |= step[c] == STEP_COMPENSATION_FAILED;
  }
  if (compensating && !still_committed) {
    state = any_comp_failed ? SAGA_ESCALATED : SAGA_COMPLETED;
  }
  return {state, next, committed, exhausted};
}

__global__ void __launch_bounds__(THREADS)
    saga_tick_kernel(int8_t* step, int8_t* retries, const uint8_t* undo, int8_t* saga_state,
                     const int* n_steps, int* cursor, const uint8_t* outcomes,
                     uint8_t* committed, uint8_t* exhausted, unsigned* counters,
                     int committed_row, int failed_row, int G, int M, int vec) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  RowResult r = {0, 0, false, false};
  if (g < G) {
    const size_t row = static_cast<size_t>(g) * M;
    if (vec) {
      uint4 s[VEC_MAX_M / 16], t[VEC_MAX_M / 16], u[VEC_MAX_M / 16];
      const int nv = M / 16;
      const uint4* srow = reinterpret_cast<const uint4*>(step + row);
      const uint4* trow = reinterpret_cast<const uint4*>(retries + row);
      const uint4* urow = reinterpret_cast<const uint4*>(undo + row);
      for (int v = 0; v < nv; ++v) {
        s[v] = srow[v];
        t[v] = trow[v];
        u[v] = urow[v];
      }
      r = tick_row(reinterpret_cast<int8_t*>(s), reinterpret_cast<int8_t*>(t),
                   reinterpret_cast<const uint8_t*>(u), M, saga_state[g], n_steps[g], cursor[g],
                   outcomes[g]);
      uint4* sout = reinterpret_cast<uint4*>(step + row);
      uint4* tout = reinterpret_cast<uint4*>(retries + row);
      for (int v = 0; v < nv; ++v) {
        sout[v] = s[v];
        tout[v] = t[v];
      }
    } else {
      r = tick_row(step + row, retries + row, undo + row, M, saga_state[g], n_steps[g],
                   cursor[g], outcomes[g]);
    }
    saga_state[g] = r.saga_state;
    cursor[g] = r.cursor;
    committed[g] = r.committed;
    exhausted[g] = r.exhausted;
  }
  if (counters == nullptr) return;  // uniform over the grid
  const unsigned n_committed = __popc(__ballot_sync(0xffffffffu, r.committed));
  const unsigned n_exhausted = __popc(__ballot_sync(0xffffffffu, r.exhausted));
  if ((threadIdx.x & 31) == 0) {
    if (n_committed) atomicAdd(counters + committed_row, n_committed);
    if (n_exhausted) atomicAdd(counters + failed_row, n_exhausted);
  }
}

}  // namespace

extern "C" const char* hv_saga_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// counters: the metrics table's u32 counter column (int32 storage), or
// null to book nothing.
extern "C" int hv_saga_tick(void* step, void* retries, const void* undo, void* saga_state,
                            const void* n_steps, void* cursor, const void* outcomes,
                            void* committed, void* exhausted, void* counters, int committed_row,
                            int failed_row, int G, int M, int vec, void* stream) {
  if (G > 0) {
    saga_tick_kernel<<<(G + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<int8_t*>(step), static_cast<int8_t*>(retries),
        static_cast<const uint8_t*>(undo), static_cast<int8_t*>(saga_state),
        static_cast<const int*>(n_steps), static_cast<int*>(cursor),
        static_cast<const uint8_t*>(outcomes), static_cast<uint8_t*>(committed),
        static_cast<uint8_t*>(exhausted), static_cast<unsigned*>(counters), committed_row,
        failed_row, G, M, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
