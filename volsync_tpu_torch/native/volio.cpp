// volio: native IO + host-side hot loops for the TPU data plane.
//
// The reference's data plane gets its IO and its boundary arithmetic
// from native code inside the vendored binaries (rsync in C, restic's
// chunker in Go); the TPU framework's device kernels are JAX/Pallas,
// and THIS library is the native runtime around them:
//
//  - a readahead file reader: a background thread streams segments into
//    a double-buffered pair ahead of the Python consumer, overlapping
//    disk IO with host->device upload and device hashing (the
//    double-buffered input pipeline of SURVEY §7 hard-part (c));
//  - the FastCDC boundary walk (select_boundaries): the only per-chunk
//    sequential host loop on the backup path, here a tight C loop over
//    the sparse candidate arrays.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
// Build: g++ -O2 -shared -fPIC -pthread -o libvolio.so volio.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Readahead reader
// ---------------------------------------------------------------------------

struct VolioReader {
    FILE* f = nullptr;
    size_t segment = 0;
    // Double buffer: the reader thread fills buffers in alternating
    // order; the consumer drains them in the same order (read_idx).
    char* buf[2] = {nullptr, nullptr};
    size_t len[2] = {0, 0};
    int fill_idx = 0;          // which buffer the thread fills next
    int read_idx = 0;          // which buffer the consumer drains next
    bool ready[2] = {false, false};
    bool eof = false;
    bool err = false;
    bool closed = false;
    std::mutex mu;
    std::condition_variable cv;
    std::thread thread;
};

static void volio_fill_loop(VolioReader* r) {
    for (;;) {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv.wait(lk, [r] { return r->closed || !r->ready[r->fill_idx]; });
        if (r->closed) return;
        int idx = r->fill_idx;
        lk.unlock();

        size_t n = fread(r->buf[idx], 1, r->segment, r->f);

        lk.lock();
        if (n > 0) {
            r->len[idx] = n;
            r->ready[idx] = true;
            r->fill_idx = 1 - idx;
        }
        if (n < r->segment) {
            // A short read is EOF only if no stream error occurred; an
            // IO error mid-file must surface as an error (a silent
            // truncated 'EOF' would commit a corrupt backup).
            if (ferror(r->f)) r->err = true;
            r->eof = true;
            r->cv.notify_all();
            return;
        }
        r->cv.notify_all();
    }
}

// Open `path` for readahead streaming in `segment`-byte segments.
// Returns an opaque handle or NULL.
void* volio_open(const char* path, size_t segment) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    VolioReader* r = new VolioReader();
    r->f = f;
    r->segment = segment;
    r->buf[0] = (char*)malloc(segment);
    r->buf[1] = (char*)malloc(segment);
    if (!r->buf[0] || !r->buf[1]) {
        free(r->buf[0]); free(r->buf[1]); fclose(f); delete r;
        return nullptr;
    }
    r->thread = std::thread(volio_fill_loop, r);
    return r;
}

// Copy the next segment into `out` (capacity >= segment). Returns the
// number of bytes (0 = EOF), or -1 on error. Blocks only if the
// readahead thread hasn't finished the next segment yet.
int64_t volio_next(void* handle, char* out) {
    VolioReader* r = (VolioReader*)handle;
    if (!r) return -1;
    std::unique_lock<std::mutex> lk(r->mu);
    int idx = r->read_idx;
    r->cv.wait(lk, [&] { return r->ready[idx] || r->eof || r->closed; });
    if (r->closed) return -1;
    if (r->err) return -1;  // IO error: fail loudly, never fake an EOF
    if (!r->ready[idx]) return 0;  // EOF and nothing left buffered
    size_t n = r->len[idx];
    memcpy(out, r->buf[idx], n);
    r->ready[idx] = false;
    r->read_idx = 1 - idx;
    r->cv.notify_all();
    return (int64_t)n;
}

void volio_close(void* handle) {
    VolioReader* r = (VolioReader*)handle;
    if (!r) return;
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->closed = true;
        r->cv.notify_all();
    }
    if (r->thread.joinable()) r->thread.join();
    fclose(r->f);
    free(r->buf[0]);
    free(r->buf[1]);
    delete r;
}

// ---------------------------------------------------------------------------
// FastCDC boundary walk (mirrors ops/gearcdc.select_boundaries exactly;
// golden-tested for equality against the Python walk)
// ---------------------------------------------------------------------------

static int64_t lower_bound_i64(const int64_t* a, int64_t n, int64_t key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (a[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// idx_s/idx_l: sorted candidate cut positions (buffer-relative).
// Emits (start, length) pairs into out (capacity out_cap pairs).
// Returns the number of pairs, or -1 if out_cap was too small.
int64_t volio_select_boundaries(
    const int64_t* idx_s, int64_t n_s,
    const int64_t* idx_l, int64_t n_l,
    int64_t length, int64_t min_size, int64_t avg_size, int64_t max_size,
    int eof, int64_t base, int64_t* out, int64_t out_cap) {
    int64_t count = 0;
    int64_t pos = 0;
    while (pos < length) {
        int64_t lo = pos + min_size - 1;
        int64_t mid = pos + avg_size - 1;
        int64_t hi = pos + max_size - 1;
        int64_t cut = -1;
        int64_t i = lower_bound_i64(idx_s, n_s, lo);
        int64_t s_limit = mid - 1;
        if (length - 1 < s_limit) s_limit = length - 1;
        if (hi < s_limit) s_limit = hi;
        if (i < n_s && idx_s[i] <= s_limit) cut = idx_s[i];
        if (cut < 0) {
            int64_t from = lo > mid ? lo : mid;
            int64_t j = lower_bound_i64(idx_l, n_l, from);
            int64_t l_limit = hi < length - 1 ? hi : length - 1;
            if (j < n_l && idx_l[j] <= l_limit) cut = idx_l[j];
        }
        if (cut < 0) {
            if (hi <= length - 1) cut = hi;
            else if (eof) cut = length - 1;
            else break;  // tail continues into the next segment
        }
        if (count >= out_cap) return -1;
        out[2 * count] = base + pos;
        out[2 * count + 1] = cut - pos + 1;
        count++;
        pos = cut + 1;
    }
    return count;
}

}  // extern "C"
