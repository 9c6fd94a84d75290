// One refinement pass of the Krylov solve as one CUDA graph launch: the
// device loop mode of the JAX package (sparsh_amg_tpu/solve/solver.py:187-195,
// `_inner_solve_dev`, a `lax.while_loop` per pass; its conditions are
// solve/krylov.py:73-77, :164-167 and :227-230).
//
// The pass graph is assembled here from graphs that PyTorch captured
// (torch.cuda.CUDAGraph(keep_graph=True), raw_cuda_graph(); see
// solve/graphs.py::PassGraph):
//
//   start (child graphs) -> loop_guard
//     -> WHILE { step (child graph) -> loop_guard }
//     -> finish (child graphs)
//
// Child graph nodes clone what they are given: the assembled graph holds
// the captured kernels' parameters (device addresses in the captures'
// memory pool), so the caller keeps the captured graphs and their pool
// alive for as long as the pass graph lives.
//
// loop_guard is a kernel of the port's own: the TPU loop's condition is a
// traced predicate of XLA's while loop.  One thread reads ||r||^2 (fp32), k
// (int32) and BiCGStab's breakdown flag (bool; none for CG and the
// stationary iteration) from the Krylov state and the pass's target and
// budget (fp64), writes (||r||^2, k, breakdown) in fp64 into prog[0..2]
// and, in a graph, sets the WHILE node's condition to
//     rr > target && isfinite(rr) && k < budget && !breakdown,
// the plain version's (solve/krylov.py::loop_continue).  Launched on its
// own (the eager pass, the tests) it writes the condition into `go`
// instead.  Bound: 25 bytes read and 24 written, nothing to compute; what
// it costs is one kernel node's launch inside the graph, once per
// iteration.
//
// Node kinds in a WHILE body (CUDA 12.4 and later): kernel, empty, child
// graph, memcpy and memset (device memory only) and conditional nodes, all
// on one device; no host, event or memory allocation nodes, and no
// dynamic parallelism.  On an H100 with CUDA 12.8 (torch 2.11) the body
// below, a child graph node holding the captured step (the flagship's:
// 81 kernel and 3 memcpy nodes) and then the guard's kernel node, builds,
// instantiates and runs; the guard calls cudaGraphSetConditional without
// relocatable device code.  torch.profiler reports a body's kernels once
// per launch of the pass graph, not once per iteration.
//
// On several NCCL ranks the step holds NCCL's collectives as kernel nodes
// (p3d(48), 2 ranks on two H100s: 149 kernel and 20 memcpy nodes) when
// NCCL_GRAPH_MIXING_SUPPORT=0; with NCCL's default each captured
// collective also brings an event wait node and event record nodes, and
// instantiation refuses the body (cudaGraphNodeTypeWaitEvent).
//
// trace_stamp is the tracer's (utils/trace.py): when tracing is on at
// capture, the step graph holds one of these one-thread kernels at the
// step's start and end and at the entry and return of each level's visit,
// so the WHILE body's device time splits by level, where neither CUDA
// events nor torch.profiler reach.  Each reads the global timer (ns) and
// adds the time since the previous stamp to its slot.  Stamps run in
// stream order inside one captured chain, so one thread and no atomics.
//
// The step updates the Krylov state in place (solve/krylov.py::
// step_inplace): a functional step's copy of each vector back into the
// state per iteration cost the flagship 0.097 ms an iteration; in place,
// the loop adds 0.011 ms an iteration over the same steps replayed as one
// chunk graph (scripts/torch_profile_solve.py --while-cost).
#include <cuda_runtime.h>

#include <cstdio>

#if CUDART_VERSION < 12040
#error "the pass graph's WHILE node needs CUDA 12.4 or later"
#endif

namespace {

__global__ void loop_guard(const float* rr, const int* k, const bool* brk,
                           const double* target, const double* budget,
                           double* prog, int* go,
                           cudaGraphConditionalHandle handle,
                           int set_handle) {
    const float r = *rr;
    const int kk = *k;
    const bool broken = brk != nullptr && *brk;
    const bool more = static_cast<double>(r) > *target && isfinite(r) &&
                      static_cast<double>(kk) < *budget && !broken;
    prog[0] = static_cast<double>(r);
    prog[1] = static_cast<double>(kk);
    prog[2] = broken ? 1.0 : 0.0;
    if (go != nullptr) *go = more ? 1 : 0;
    if (set_handle) cudaGraphSetConditional(handle, more ? 1u : 0u);
}

// buf: acc[cap] (ns), cnt[cap], last; a reset stamp only sets last.
__global__ void trace_stamp(unsigned long long* buf, int cap, int slot,
                            int reset) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (!reset) {
        buf[slot] += now - buf[2 * cap];
        buf[cap + slot] += 1;
    }
    buf[2 * cap] = now;
}

struct Guard {
    const float* rr;
    const int* k;
    const bool* brk;
    const double* target;
    const double* budget;
    double* prog;
};

#define TRY(call)                      \
    do {                               \
        cudaError_t e_ = (call);       \
        if (e_ != cudaSuccess) {       \
            *where = #call;            \
            return e_;                 \
        }                              \
    } while (0)

// A guard kernel node in `graph` after `dep` (none when null).
cudaError_t add_guard(cudaGraphNode_t* node, cudaGraph_t graph,
                      cudaGraphNode_t dep, const Guard& g,
                      cudaGraphConditionalHandle handle, const char** where) {
    int* go = nullptr;
    int set_handle = 1;
    void* args[] = {(void*)&g.rr,     (void*)&g.k,    (void*)&g.brk,
                    (void*)&g.target, (void*)&g.budget, (void*)&g.prog,
                    (void*)&go,       (void*)&handle, (void*)&set_handle};
    cudaKernelNodeParams p = {};
    p.func = (void*)loop_guard;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    TRY(cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr, dep ? 1 : 0,
                               &p));
    return cudaSuccess;
}

// Child graph nodes of graphs[0..n) in a chain after *prev (updated).
cudaError_t add_children(cudaGraph_t graph, void* const* graphs, int n,
                         cudaGraphNode_t* prev, const char** where) {
    for (int i = 0; i < n; ++i) {
        cudaGraphNode_t node;
        TRY(cudaGraphAddChildGraphNode(&node, graph, *prev ? prev : nullptr,
                                       *prev ? 1 : 0,
                                       static_cast<cudaGraph_t>(graphs[i])));
        *prev = node;
    }
    return cudaSuccess;
}

cudaError_t assemble(cudaGraph_t graph, void* const* heads, int n_heads,
                     void* body, void* const* tails, int n_tails,
                     const Guard& g, const char** where) {
    cudaGraphNode_t prev = nullptr;
    TRY(add_children(graph, heads, n_heads, &prev, where));
    cudaGraphConditionalHandle handle;
    TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault));
    cudaGraphNode_t node;
    TRY(add_guard(&node, graph, prev, g, handle, where));
    prev = node;

    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    TRY(cudaGraphAddNode(&node, graph, &prev, 1, &cp));
    prev = node;
    cudaGraph_t loop = cp.conditional.phGraph_out[0];
    cudaGraphNode_t step;
    TRY(cudaGraphAddChildGraphNode(&step, loop, nullptr, 0,
                                   static_cast<cudaGraph_t>(body)));
    TRY(add_guard(&node, loop, step, g, handle, where));

    TRY(add_children(graph, tails, n_tails, &prev, where));
    return cudaSuccess;
}

}  // namespace

// The guard on its own: go = the loop condition, prog[0..2] its record.
extern "C" int loop_guard_launch(const void* rr, const void* k,
                                 const void* brk, const void* target,
                                 const void* budget, void* prog, void* go,
                                 void* stream) {
    loop_guard<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rr), static_cast<const int*>(k),
        static_cast<const bool*>(brk), static_cast<const double*>(target),
        static_cast<const double*>(budget), static_cast<double*>(prog),
        static_cast<int*>(go), 0, 0);
    return cudaGetLastError();
}

// One stamp (see trace_stamp) on `stream`; captured like any launch.
extern "C" int trace_stamp_launch(void* buf, int cap, int slot, int reset,
                                  void* stream) {
    trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(buf), cap, slot, reset);
    return cudaGetLastError();
}

// Assemble, instantiate and upload (on `stream`) the pass graph of heads,
// the WHILE loop over body and tails (cudaGraph_t handles); brk may be
// null.  On success *exec_out holds the cudaGraphExec_t.  On failure the
// CUDA call that failed and its error are written into msg.
extern "C" int pass_graph_create(void* const* heads, int n_heads, void* body,
                                 void* const* tails, int n_tails,
                                 const void* rr, const void* k,
                                 const void* brk, const void* target,
                                 const void* budget, void* prog,
                                 void** exec_out, char* msg, int msg_len,
                                 void* stream) {
    const Guard g = {static_cast<const float*>(rr), static_cast<const int*>(k),
                     static_cast<const bool*>(brk),
                     static_cast<const double*>(target),
                     static_cast<const double*>(budget),
                     static_cast<double*>(prog)};
    const char* where = "cudaGraphCreate";
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaGraphCreate(&graph, 0);
    if (err == cudaSuccess)
        err = assemble(graph, heads, n_heads, body, tails, n_tails, g, &where);
    cudaGraphInstantiateParams ip = {};
    if (err == cudaSuccess) {
        where = "cudaGraphInstantiateWithParams";
        ip.flags = cudaGraphInstantiateFlagUpload;
        ip.uploadStream = static_cast<cudaStream_t>(stream);
        cudaGraphExec_t exec = nullptr;
        err = cudaGraphInstantiateWithParams(&exec, graph, &ip);
        if (err == cudaSuccess) *exec_out = exec;
    }
    // the node instantiation refused, by cudaGraphNodeType (-1: none)
    int err_node = -1;
    cudaGraphNodeType t;
    if (err != cudaSuccess && ip.errNode_out != nullptr &&
        cudaGraphNodeGetType(ip.errNode_out, &t) == cudaSuccess)
        err_node = static_cast<int>(t);
    if (err != cudaSuccess && msg != nullptr && msg_len > 0)
        snprintf(msg, msg_len,
                 "%s: %s (%s), instantiate result %d, node type %d", where,
                 cudaGetErrorName(err), cudaGetErrorString(err),
                 static_cast<int>(ip.result_out), err_node);
    if (graph != nullptr) cudaGraphDestroy(graph);
    return err;
}

// counts[t] += the nodes of cudaGraphNodeType t in `graph`, child graphs
// entered (t < n); for the record of what a captured step holds.
extern "C" int graph_node_counts(void* graph, int* counts, int n) {
    cudaGraph_t g = static_cast<cudaGraph_t>(graph);
    size_t num = 0;
    cudaError_t err = cudaGraphGetNodes(g, nullptr, &num);
    if (err != cudaSuccess || num == 0) return err;
    cudaGraphNode_t* nodes = new cudaGraphNode_t[num];
    err = cudaGraphGetNodes(g, nodes, &num);
    for (size_t i = 0; err == cudaSuccess && i < num; ++i) {
        cudaGraphNodeType t;
        err = cudaGraphNodeGetType(nodes[i], &t);
        if (err != cudaSuccess) break;
        if (static_cast<int>(t) < n) ++counts[static_cast<int>(t)];
        if (t == cudaGraphNodeTypeGraph) {
            cudaGraph_t child;
            err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
            if (err == cudaSuccess) err = static_cast<cudaError_t>(
                graph_node_counts(child, counts, n));
        }
    }
    delete[] nodes;
    return err;
}

extern "C" int pass_graph_launch(void* exec, void* stream) {
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pass_graph_destroy(void* exec) {
    return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
