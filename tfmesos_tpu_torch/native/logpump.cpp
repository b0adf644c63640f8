// Native line pump for Mode-B child stdout (see tfmesos_tpu_torch/logpump.py;
// tfmesos_tpu/native/logpump.cpp with one change, below).
//
// Replaces the reference's per-line Python loop (server.py:99-102) with a
// splice loop in C++: read chunks from src_fd, mirror the complete lines to
// out_fd, and retransmit each complete line (prefixed) to fwd_fd.  Partial
// lines are buffered, so both streams stay line-framed even when the child
// writes in arbitrary chunks; the trailing unterminated line goes out at EOF.
// The JAX package's pump mirrors each chunk verbatim to out_fd as it
// arrives: the bytes are the same, but a line can be split across writes,
// and tfrun, which prints the forwarded lines to the stdout the local
// mirror shares, then interleaves another line into it.
//
// Built with g++ at first use by kernels/build.build_host("logpump") into
// build/tfmesos_tpu_torch/host-<hash>/liblogpump.so and loaded via ctypes.

#include <cerrno>
#include <cstring>
#include <string>
#include <unistd.h>
#include <vector>

namespace {

// Write all of buf to fd, retrying on EINTR/partial writes.
// Returns false on unrecoverable error.
bool write_all(int fd, const char* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::write(fd, buf, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

}  // namespace

extern "C" int tpumesos_pump_lines(int src_fd, int out_fd, int fwd_fd,
                                   const char* prefix, size_t prefix_len) {
  std::vector<char> chunk(1 << 16);
  std::string pending;  // bytes after the last complete line
  bool fwd_ok = fwd_fd >= 0;

  for (;;) {
    ssize_t n = ::read(src_fd, chunk.data(), chunk.size());
    if (n < 0) {
      if (errno == EINTR) continue;
      return 1;
    }
    if (n == 0) break;  // EOF: child closed stdout

    pending.append(chunk.data(), static_cast<size_t>(n));
    size_t end = pending.rfind('\n');
    if (end == std::string::npos) continue;  // no complete line yet
    ++end;
    // The local mirror gets whole lines only: its stdout may be shared
    // with other writers (tfrun prints the forwarded lines to the same
    // stream), and a line split across writes would interleave.
    if (!write_all(out_fd, pending.data(), end)) return 1;
    size_t start = 0;
    while (fwd_ok && start < end) {
      size_t nl = pending.find('\n', start);
      std::string line;
      line.reserve(prefix_len + (nl - start) + 1);
      line.append(prefix, prefix_len);
      line.append(pending, start, nl - start + 1);
      if (!write_all(fwd_fd, line.data(), line.size())) {
        fwd_ok = false;  // collector went away; keep local mirroring alive
        break;
      }
      start = nl + 1;
    }
    pending.erase(0, end);
  }

  // Mirror and forward any trailing unterminated line.
  if (!pending.empty()) {
    if (!write_all(out_fd, pending.data(), pending.size())) return 1;
    if (fwd_ok) {
      std::string line;
      line.append(prefix, prefix_len);
      line.append(pending);
      write_all(fwd_fd, line.data(), line.size());
    }
  }
  return 0;
}
