// rfsim: native IQ-exchange transport (rfsimulator analog).
//
// Re-design of the reference's radio/rfsimulator/simulator.c:
// processes (gNB sim, UE sim, channel hub) exchange timestamped IQ sample
// blocks over TCP so multi-process end-to-end tests run without radio
// hardware.  This C++ runtime piece handles sockets, framing and
// timestamp-aligned ring buffering; all signal processing stays in JAX.
//
// Protocol: little-endian frames
//   [u32 magic 0x52465349][u32 n_samples][i64 timestamp][u32 n_ant][u32 flags]
//   followed by n_samples * n_ant * 2 float32 (interleaved I/Q).
//
// Exposed as a C ABI for Python ctypes (no pybind11 dependency).

#include <arpa/inet.h>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x52465349;  // "RFSI"

struct FrameHeader {
  uint32_t magic;
  uint32_t n_samples;
  int64_t timestamp;
  uint32_t n_ant;
  uint32_t flags;
} __attribute__((packed));

struct Frame {
  int64_t timestamp;
  uint32_t n_ant;
  std::vector<float> iq;  // n_samples * n_ant * 2
};

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Timestamp-ordered queue of received frames from one peer.
struct RxQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Frame> frames;
  bool closed = false;

  void push(Frame&& f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      frames.push_back(std::move(f));
    }
    cv.notify_all();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv.notify_all();
  }
};

// Channel model applied inside the hub on received IQ (the rfsimulator
// apply_channelmod / rfsimu_setchanmod_cmd analog, radio/rfsimulator/
// apply_channelmod.c): static complex FIR per antenna + AWGN, settable
// at runtime from Python (the reference sets it via telnet).
struct ChannelState {
  std::mutex mu;
  std::vector<float> taps;   // n_taps complex, interleaved re/im
  std::vector<float> hist;   // (n_taps-1) samples per antenna, interleaved
  float noise_sigma = 0.0f;  // per-component AWGN std dev
  uint64_t rng = 0x9E3779B97F4A7C15ull;
  bool enabled = false;
};

struct Endpoint {
  int fd = -1;
  int listen_fd = -1;
  std::thread reader;
  RxQueue rx;
  // reassembly buffer: samples drained from frames, contiguous in time
  std::vector<float> pending;  // interleaved, n_ant*2 floats per sample
  int64_t pending_ts = 0;       // timestamp of pending[0]
  uint32_t n_ant = 1;
  ChannelState chan;

  ~Endpoint() {
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    rx.close();
    if (reader.joinable()) reader.join();
    if (fd >= 0) ::close(fd);
    if (listen_fd >= 0) ::close(listen_fd);
  }
};

inline float gauss(uint64_t* s) {
  // xorshift64* -> Box-Muller (one component per call, cheap + adequate
  // for a test channel; the reference uses gaussdouble() similarly)
  auto next = [&]() {
    *s ^= *s >> 12; *s ^= *s << 25; *s ^= *s >> 27;
    return (*s * 0x2545F4914F6CDD1Dull >> 11) * (1.0 / 9007199254740992.0);
  };
  double u1 = next(), u2 = next();
  if (u1 < 1e-12) u1 = 1e-12;
  return static_cast<float>(std::sqrt(-2.0 * std::log(u1)) *
                            std::cos(2.0 * M_PI * u2));
}

void apply_channel(Endpoint* ep, Frame* f) {
  std::lock_guard<std::mutex> lk(ep->chan.mu);
  if (!ep->chan.enabled) return;
  const size_t n_taps = ep->chan.taps.size() / 2;
  const uint32_t A = f->n_ant;
  const size_t n = f->iq.size() / (A * 2);
  if (ep->chan.hist.size() != (n_taps - 1) * A * 2)
    ep->chan.hist.assign((n_taps - 1) * A * 2, 0.0f);
  std::vector<float> out(f->iq.size());
  for (uint32_t a = 0; a < A; ++a) {
    for (size_t i = 0; i < n; ++i) {
      float yr = 0.0f, yi = 0.0f;
      for (size_t k = 0; k < n_taps; ++k) {
        float xr, xi;
        if (i >= k) {
          xr = f->iq[((i - k) * A + a) * 2];
          xi = f->iq[((i - k) * A + a) * 2 + 1];
        } else {  // reach into history (previous frame tail)
          size_t h = (n_taps - 1) - (k - i);
          xr = ep->chan.hist[(h * A + a) * 2];
          xi = ep->chan.hist[(h * A + a) * 2 + 1];
        }
        const float tr = ep->chan.taps[k * 2], ti = ep->chan.taps[k * 2 + 1];
        yr += tr * xr - ti * xi;
        yi += tr * xi + ti * xr;
      }
      out[(i * A + a) * 2] = yr + ep->chan.noise_sigma * gauss(&ep->chan.rng);
      out[(i * A + a) * 2 + 1] = yi + ep->chan.noise_sigma * gauss(&ep->chan.rng);
    }
  }
  // save tail as history for the next frame
  for (size_t h = 0; h < n_taps - 1; ++h) {
    size_t i = n >= (n_taps - 1) ? n - (n_taps - 1) + h : h;
    for (uint32_t a = 0; a < A; ++a) {
      ep->chan.hist[(h * A + a) * 2] = f->iq[(i * A + a) * 2];
      ep->chan.hist[(h * A + a) * 2 + 1] = f->iq[(i * A + a) * 2 + 1];
    }
  }
  f->iq.swap(out);
}

void reader_loop(Endpoint* ep) {
  for (;;) {
    FrameHeader h;
    if (!read_exact(ep->fd, &h, sizeof(h)) || h.magic != kMagic) break;
    Frame f;
    f.timestamp = h.timestamp;
    f.n_ant = h.n_ant;
    f.iq.resize(static_cast<size_t>(h.n_samples) * h.n_ant * 2);
    if (!read_exact(ep->fd, f.iq.data(), f.iq.size() * sizeof(float))) break;
    apply_channel(ep, &f);
    ep->rx.push(std::move(f));
  }
  ep->rx.close();
}

int set_common_opts(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

}  // namespace

extern "C" {

// Create a listening endpoint and block until one peer connects.
// Returns handle or nullptr.
void* rfsim_listen(uint16_t port, uint32_t n_ant) {
  auto ep = std::make_unique<Endpoint>();
  ep->n_ant = n_ant;
  ep->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (ep->listen_fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(ep->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (::bind(ep->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
    return nullptr;
  if (::listen(ep->listen_fd, 1) < 0) return nullptr;
  ep->fd = ::accept(ep->listen_fd, nullptr, nullptr);
  if (ep->fd < 0) return nullptr;
  set_common_opts(ep->fd);
  ep->reader = std::thread(reader_loop, ep.get());
  return ep.release();
}

// Connect to a listening endpoint (retries until timeout_ms).
void* rfsim_connect(const char* host, uint16_t port, uint32_t n_ant,
                    int timeout_ms) {
  auto ep = std::make_unique<Endpoint>();
  ep->n_ant = n_ant;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  ::inet_pton(AF_INET, host, &addr.sin_addr);
  int waited = 0;
  for (;;) {
    ep->fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (::connect(ep->fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0)
      break;
    ::close(ep->fd);
    ep->fd = -1;
    if (waited >= timeout_ms) return nullptr;
    ::usleep(50 * 1000);
    waited += 50;
  }
  set_common_opts(ep->fd);
  ep->reader = std::thread(reader_loop, ep.get());
  return ep.release();
}

// trx_write_func analog: send n_samples starting at `timestamp`.
// iq: interleaved float32, n_samples * n_ant * 2 values.
int rfsim_write(void* handle, int64_t timestamp, const float* iq,
                uint32_t n_samples) {
  auto* ep = static_cast<Endpoint*>(handle);
  FrameHeader h{kMagic, n_samples, timestamp, ep->n_ant, 0};
  std::vector<uint8_t> buf(sizeof(h) + static_cast<size_t>(n_samples) * ep->n_ant * 8);
  std::memcpy(buf.data(), &h, sizeof(h));
  std::memcpy(buf.data() + sizeof(h), iq,
              static_cast<size_t>(n_samples) * ep->n_ant * 8);
  return write_exact(ep->fd, buf.data(), buf.size()) ? 0 : -1;
}

// trx_read_func analog: blocking read of n_samples at `timestamp`.
// Gaps (peer sent nothing for a span) are zero-filled only if the peer
// has advanced past them; otherwise blocks.
int rfsim_read(void* handle, int64_t timestamp, float* iq, uint32_t n_samples) {
  auto* ep = static_cast<Endpoint*>(handle);
  const size_t spf = static_cast<size_t>(ep->n_ant) * 2;  // floats per sample
  std::memset(iq, 0, static_cast<size_t>(n_samples) * spf * sizeof(float));
  int64_t end = timestamp + n_samples;
  for (;;) {
    // drain queue into pending
    {
      std::unique_lock<std::mutex> lk(ep->rx.mu);
      while (!ep->rx.frames.empty()) {
        Frame f = std::move(ep->rx.frames.front());
        ep->rx.frames.pop_front();
        if (ep->pending.empty()) {
          ep->pending_ts = f.timestamp;
          ep->pending = std::move(f.iq);
        } else {
          int64_t cur_end = ep->pending_ts +
              static_cast<int64_t>(ep->pending.size() / spf);
          if (f.timestamp > cur_end)  // gap: zero fill
            ep->pending.resize(ep->pending.size() +
                               static_cast<size_t>(f.timestamp - cur_end) * spf,
                               0.0f);
          ep->pending.insert(ep->pending.end(), f.iq.begin(), f.iq.end());
        }
      }
      int64_t have_end = ep->pending.empty()
          ? ep->pending_ts
          : ep->pending_ts + static_cast<int64_t>(ep->pending.size() / spf);
      if (have_end >= end || ep->rx.closed) {
        // copy overlap [timestamp, end) from pending
        if (!ep->pending.empty()) {
          int64_t src0 = std::max(timestamp, ep->pending_ts);
          int64_t src1 = std::min(end, have_end);
          if (src1 > src0) {
            std::memcpy(iq + (src0 - timestamp) * spf,
                        ep->pending.data() + (src0 - ep->pending_ts) * spf,
                        static_cast<size_t>(src1 - src0) * spf * sizeof(float));
          }
          // drop consumed samples
          if (end > ep->pending_ts) {
            size_t drop = static_cast<size_t>(
                std::min<int64_t>(end - ep->pending_ts,
                                  static_cast<int64_t>(ep->pending.size() / spf)));
            ep->pending.erase(ep->pending.begin(),
                              ep->pending.begin() + drop * spf);
            ep->pending_ts += drop;
          }
        }
        return ep->rx.closed && have_end < end ? -1 : 0;
      }
      // need more data: wait
      ep->rx.cv.wait_for(lk, std::chrono::milliseconds(100));
    }
  }
}

// rfsimu_setchanmod_cmd analog: set (or clear with n_taps=0) the FIR
// channel + AWGN applied to this endpoint's RECEIVED samples.
// taps: n_taps complex float32 interleaved re/im.
int rfsim_set_channel(void* handle, const float* taps, uint32_t n_taps,
                      float noise_sigma) {
  auto* ep = static_cast<Endpoint*>(handle);
  std::lock_guard<std::mutex> lk(ep->chan.mu);
  if (n_taps == 0) {
    ep->chan.enabled = false;
    ep->chan.taps.clear();
    ep->chan.hist.clear();
    return 0;
  }
  ep->chan.taps.assign(taps, taps + static_cast<size_t>(n_taps) * 2);
  ep->chan.hist.assign((static_cast<size_t>(n_taps) - 1) * ep->n_ant * 2, 0.0f);
  ep->chan.noise_sigma = noise_sigma;
  ep->chan.enabled = true;
  return 0;
}

void rfsim_close(void* handle) {
  delete static_cast<Endpoint*>(handle);
}

// ---- iqplayer analog: record/replay IQ to file (radio/iqplayer) ----

int rfsim_record(const char* path, const float* iq, uint64_t n_floats) {
  FILE* f = ::fopen(path, "wb");
  if (!f) return -1;
  size_t w = ::fwrite(iq, sizeof(float), n_floats, f);
  ::fclose(f);
  return w == n_floats ? 0 : -1;
}

int64_t rfsim_replay(const char* path, float* iq, uint64_t max_floats) {
  FILE* f = ::fopen(path, "rb");
  if (!f) return -1;
  size_t r = ::fread(iq, sizeof(float), max_floats, f);
  ::fclose(f);
  return static_cast<int64_t>(r);
}

}  // extern "C"
