// Native record IO for the GREB direct-access binary formats.
//
// The reference does sequential Fortran direct-access reads of fixed-length
// float32 records (src/greb.f90:1018-1027, 1073-1085).  This library is
// the record reader and writer of greb_tpu_torch/io/binio.py: batched
// pread/pwrite with the GIL released (the Python side calls through
// ctypes), an optional parallel reader thread pool for the 13.5 MB
// climatology sweeps, and O_DIRECT-free page-cache-friendly access.  The
// same source as greb_tpu/native/recordio.cpp.
//
// Build: greb_tpu_torch/io/native_recordio.py compiles it at first use
// (g++ -O3 -fPIC -std=c++17 -shared -lpthread) into
// greb_tpu_torch/_build/librecordio.so.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read nrec records of recl bytes at 0-based indices idx[i] into out
// (contiguous, nrec*recl bytes).  Returns 0 on success, -errno on failure.
int greb_read_records(const char* path, int64_t recl, const int64_t* idx,
                      int64_t nrec, uint8_t* out, int nthreads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;

  int err = 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if (nrec < nthreads * 4) nthreads = 1;

  auto worker = [&](int64_t lo, int64_t hi, int* werr) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t off = idx[i] * recl;
      uint8_t* dst = out + i * recl;
      int64_t done = 0;
      while (done < recl) {
        ssize_t n = pread(fd, dst + done, recl - done, off + done);
        if (n <= 0) { *werr = (n == 0) ? EIO : errno; return; }
        done += n;
      }
    }
  };

  if (nthreads == 1) {
    worker(0, nrec, &err);
  } else {
    std::vector<std::thread> ts;
    std::vector<int> errs(nthreads, 0);
    int64_t chunk = (nrec + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(nrec, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back(worker, lo, hi, &errs[t]);
    }
    for (auto& th : ts) th.join();
    for (int e : errs) if (e) err = e;
  }
  close(fd);
  return err ? -err : 0;
}

// Write nrec contiguous records starting at 0-based record index start.
// Creates the file if needed. Returns 0 on success, -errno on failure.
int greb_write_records(const char* path, int64_t recl, int64_t start,
                       const uint8_t* data, int64_t nrec) {
  int fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -errno;
  int64_t total = nrec * recl;
  int64_t off = start * recl;
  int64_t done = 0;
  while (done < total) {
    ssize_t n = pwrite(fd, data + done, total - done, off + done);
    if (n <= 0) { int e = errno; close(fd); return -(e ? e : EIO); }
    done += n;
  }
  close(fd);
  return 0;
}

int64_t greb_file_records(const char* path, int64_t recl) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  return st.st_size / recl;
}

}  // extern "C"
