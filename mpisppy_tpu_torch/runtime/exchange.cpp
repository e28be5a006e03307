// Host-side inter-cylinder exchange: seqlock double-buffer windows
// (the port's copy of the JAX package's runtime/exchange.cpp; the two
// libraries share one memory layout, so either can read a window file
// the other writes).
//
// Counterpart of the reference's one-sided MPI RMA windows
// (reference mpisppy/cylinders/spcommunicator.py:93-120: MPI.Win with
// Lock/Put/Unlock writes, Lock/Get/Unlock reads, and a trailing
// monotonically-increasing write_id slot; kill signal = write_id -1,
// hub.py:438-450).  Here a window is a shared-memory region (mmap'd
// file for cross-process / multi-host-gateway use, heap for in-process
// threads) guarded by a SEQLOCK: the writer increments `seq` to an odd
// value, stores the payload + write_id, then bumps `seq` to the next
// even value; readers snapshot, and retry when `seq` was odd or moved
// — the same torn-read protection the reference gets from the
// write_id consensus check (spoke.py:99-118), without any reader-side
// locking of the writer.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libexchange.so exchange.cpp
// (runtime/native.py builds it at first use into build/runtime/,
// keyed by a hash of this source).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <new>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
    std::atomic<int64_t> seq;       // even = stable, odd = write nobody
    std::atomic<int64_t> write_id;  // -1 == KILL
    int64_t length;                 // payload doubles
};

struct Handle {
    Header* hdr;
    double* data;
    size_t map_bytes;
    int fd;          // -1 => heap-backed
};

size_t region_bytes(int64_t length) {
    return sizeof(Header) + static_cast<size_t>(length) * sizeof(double);
}

}  // namespace

extern "C" {

// path == nullptr -> private in-process window (threads).
// Otherwise an mmap'd file shared across processes.  reset != 0
// reinitializes an existing file's header — a leftover kill flag or
// stale write_id from a previous run must not leak into a new one.
void* exch_create(const char* path, int64_t length, int reset) {
    if (length <= 0) return nullptr;
    const size_t bytes = region_bytes(length);
    Handle* h = new (std::nothrow) Handle();
    if (!h) return nullptr;
    h->map_bytes = bytes;
    h->fd = -1;
    void* mem = nullptr;
    if (path == nullptr) {
        mem = ::mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (mem == MAP_FAILED) { delete h; return nullptr; }
    } else {
        int fd = ::open(path, O_RDWR | O_CREAT, 0644);
        if (fd < 0) { delete h; return nullptr; }
        bool fresh = false;
        struct stat st;
        if (::fstat(fd, &st) == 0 &&
            st.st_size < static_cast<off_t>(bytes)) {
            if (::ftruncate(fd, bytes) != 0) {
                ::close(fd); delete h; return nullptr;
            }
            fresh = true;
        }
        mem = ::mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
        if (mem == MAP_FAILED) { ::close(fd); delete h; return nullptr; }
        h->fd = fd;
        if (!fresh) {
            // existing file: sanity-check recorded length
            Header* hdr = reinterpret_cast<Header*>(mem);
            if (hdr->length != 0 && hdr->length != length) {
                ::munmap(mem, bytes); ::close(fd); delete h;
                return nullptr;
            }
        }
    }
    h->hdr = reinterpret_cast<Header*>(mem);
    h->data = reinterpret_cast<double*>(
        reinterpret_cast<char*>(mem) + sizeof(Header));
    // initialize if virgin (length==0) or explicitly reset
    if (h->hdr->length == 0 || reset) {
        h->hdr->seq.store(0, std::memory_order_relaxed);
        h->hdr->write_id.store(0, std::memory_order_relaxed);
        h->hdr->length = length;
    }
    return h;
}

void exch_close(void* vh) {
    if (!vh) return;
    Handle* h = static_cast<Handle*>(vh);
    ::munmap(h->hdr, h->map_bytes);
    if (h->fd >= 0) ::close(h->fd);
    delete h;
}

// write_id < 0 -> auto-increment.  Returns the id written.
int64_t exch_write(void* vh, const double* vals, int64_t n,
                   int64_t write_id) {
    Handle* h = static_cast<Handle*>(vh);
    if (!h || n != h->hdr->length) return -2;
    Header* hdr = h->hdr;
    int64_t s = hdr->seq.load(std::memory_order_relaxed);
    hdr->seq.store(s + 1, std::memory_order_release);   // odd: in write
    std::atomic_thread_fence(std::memory_order_release);
    std::memcpy(h->data, vals, n * sizeof(double));
    int64_t id = write_id >= 0
        ? write_id
        : hdr->write_id.load(std::memory_order_relaxed) + 1;
    hdr->write_id.store(id, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);
    hdr->seq.store(s + 2, std::memory_order_release);   // even: stable
    return id;
}

// Snapshot into out; returns the write_id of the snapshot.
int64_t exch_read(void* vh, double* out, int64_t n) {
    Handle* h = static_cast<Handle*>(vh);
    if (!h || n != h->hdr->length) return -2;
    Header* hdr = h->hdr;
    while (true) {
        int64_t s0 = hdr->seq.load(std::memory_order_acquire);
        if (s0 & 1) continue;                       // write in flight
        std::atomic_thread_fence(std::memory_order_acquire);
        std::memcpy(out, h->data, n * sizeof(double));
        int64_t id = hdr->write_id.load(std::memory_order_relaxed);
        std::atomic_thread_fence(std::memory_order_acquire);
        int64_t s1 = hdr->seq.load(std::memory_order_acquire);
        if (s0 == s1) return id;                    // consistent
    }
}

int64_t exch_write_id(void* vh) {
    Handle* h = static_cast<Handle*>(vh);
    return h ? h->hdr->write_id.load(std::memory_order_acquire) : -2;
}

void exch_kill(void* vh) {
    Handle* h = static_cast<Handle*>(vh);
    if (h) h->hdr->write_id.store(-1, std::memory_order_release);
}

}  // extern "C"
