// tb_client.h — public C ABI of the tigerbeetle_tpu native client.
//
// Two client APIs over the same TCP wire protocol (256-byte header +
// body, see tigerbeetle_tpu_torch/vsr/wire.py):
//
//  1. The synchronous session API (tb_client_init / tb_client_request)
//     implemented in tb_runtime.cpp — one blocking round-trip at a
//     time.  Kept for simple callers and the Python ctypes binding.
//
//  2. The asynchronous packet API (tb_async_*) implemented in
//     tb_async.cpp — the analog of the reference's packet-based
//     tb_client (reference: src/clients/c/tb_client.zig:1-142,
//     src/clients/c/tb_client/context.zig): callers submit
//     tb_packet_t's from any thread; a dedicated IO thread owns the
//     socket, coalesces queued packets of the same batchable operation
//     into one request (reference: batch_logical_allowed,
//     src/state_machine.zig:122-131), keeps one request in flight per
//     session (the VSR client invariant), demultiplexes batched
//     replies back per packet, and fires the completion callback from
//     the IO thread.  Many packets can be in flight at once and
//     completions are NOT in submission order (a later packet batched
//     into an earlier request completes first).
//
// All language bindings (Go / TypeScript sources under clients/) speak
// either this ABI or the TCP protocol directly.

#ifndef TB_CLIENT_H
#define TB_CLIENT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---------------------------------------------------------------------
// Shared wire-level constants (tigerbeetle_tpu_torch/types.py Operation).

enum TB_OPERATION {
    TB_OPERATION_PULSE = 128,
    TB_OPERATION_CREATE_ACCOUNTS = 129,
    TB_OPERATION_CREATE_TRANSFERS = 130,
    TB_OPERATION_LOOKUP_ACCOUNTS = 131,
    TB_OPERATION_LOOKUP_TRANSFERS = 132,
    TB_OPERATION_GET_ACCOUNT_TRANSFERS = 133,
    TB_OPERATION_GET_ACCOUNT_BALANCES = 134,
};

// ---------------------------------------------------------------------
// Synchronous session API (tb_runtime.cpp).

typedef struct tb_client tb_client_t;

tb_client_t* tb_client_init(const char* host, uint16_t port,
                            uint64_t cluster, uint64_t client_lo,
                            uint64_t client_hi);
void tb_client_deinit(tb_client_t* client);

// Returns reply body length (>= 0) or a negative status:
// -2 evicted, -3 timeout, -4 io error, -5 reply buffer too small.
int64_t tb_client_request(tb_client_t* client, uint8_t operation,
                          const uint8_t* body, uint32_t body_len,
                          uint8_t* reply_buf, uint32_t reply_cap,
                          int timeout_ms);

// ---------------------------------------------------------------------
// Asynchronous packet API (tb_async.cpp).

typedef enum TB_PACKET_STATUS {
    TB_PACKET_OK = 0,
    TB_PACKET_TOO_MUCH_DATA = 1,      // > batch_max events for the op
    TB_PACKET_INVALID_OPERATION = 2,  // unknown operation byte
    TB_PACKET_INVALID_DATA_SIZE = 3,  // not a multiple of the event size
    TB_PACKET_CLIENT_EVICTED = 4,     // session evicted by the cluster
    TB_PACKET_CLIENT_SHUTDOWN = 5,    // deinit before completion
} TB_PACKET_STATUS;

// One request unit.  The caller owns the packet and its data buffer;
// both must stay valid until the completion callback fires for the
// packet.  `next` is internal queue linkage (reference packet layout:
// src/clients/c/tb_client/packet.zig).
typedef struct tb_packet {
    struct tb_packet* next;  // internal; must be NULL on submit
    void* user_data;         // opaque, returned in the completion
    uint8_t operation;       // TB_OPERATION_*
    uint8_t status;          // TB_PACKET_STATUS, set before completion
    uint32_t data_size;      // bytes in `data`
    const void* data;        // event array (wire layout)
} tb_packet_t;

typedef struct tb_async_client tb_async_client_t;

// Completion callback: fired on the IO thread once per packet, exactly
// once.  `reply`/`reply_len` hold the packet's slice of the reply body
// (valid only for the duration of the callback; NULL when status !=
// TB_PACKET_OK).
typedef void (*tb_async_on_completion)(void* context, tb_packet_t* packet,
                                       const uint8_t* reply,
                                       uint32_t reply_len);

// Create a client session and spawn its IO thread.  The thread
// connects, registers the session, and starts draining submissions.
// Returns NULL on resource exhaustion (never blocks on the network).
tb_async_client_t* tb_async_init(const char* host, uint16_t port,
                                 uint64_t cluster, uint64_t client_lo,
                                 uint64_t client_hi,
                                 tb_async_on_completion on_completion,
                                 void* completion_context);

// Submit a packet (thread-safe, non-blocking).  Returns 0 on enqueue;
// on immediate validation failure the packet status is set and the
// completion fires synchronously on the calling thread, return -1.
int tb_async_submit(tb_async_client_t* client, tb_packet_t* packet);

// Flow control for tests and batch-heavy callers: while paused the IO
// thread completes in-flight requests but pops no new submissions, so
// everything submitted during the pause coalesces maximally on resume.
void tb_async_pause(tb_async_client_t* client);
void tb_async_resume(tb_async_client_t* client);

// Join the IO thread.  Every packet not yet completed — queued or in
// flight — completes with TB_PACKET_CLIENT_SHUTDOWN.  NOTE: an
// in-flight request may still commit server-side; SHUTDOWN means
// "completion unknown", not "not executed".  To resolve the ambiguity,
// reconnect under the SAME client id: the session's at-most-once
// dedupe replays the stored reply instead of re-executing.
void tb_async_deinit(tb_async_client_t* client);

#ifdef __cplusplus
}
#endif

#endif  // TB_CLIENT_H
