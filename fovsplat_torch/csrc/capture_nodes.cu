// The nodes of a CUDA graph while a stream captures it: the stage map of
// utils/graphs.Graph (utils/profiling.py) reads their count at every span
// boundary of a capture, and their types once the captured function has
// returned. No kernel; nothing is added to the graph.
#include <vector>

#include "common.cuh"

// The number of nodes the capture in progress on `stream` holds, into
// *count; the types (cudaGraphNodeType) of the first min(count, cap) of
// them, in the order the graph lists them, into `types`. Returns a
// cudaError_t; cudaErrorIllegalState when no capture is in progress.
FS_EXPORT int fs_capture_nodes(void* stream, long long cap, int* types,
                               long long* count) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return cudaErrorIllegalState;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  *count = static_cast<long long>(n);
  size_t m = cap < static_cast<long long>(n) ? static_cast<size_t>(cap) : n;
  if (m == 0) return cudaSuccess;
  std::vector<cudaGraphNode_t> nodes(m);
  err = cudaGraphGetNodes(graph, nodes.data(), &m);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < m; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return err;
    types[i] = static_cast<int>(t);
  }
  return cudaSuccess;
}
