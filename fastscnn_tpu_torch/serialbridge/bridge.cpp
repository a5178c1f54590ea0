// Serial actuation bridge — native (C++) implementation of the wheel-speed
// UART protocol shared by the host controller and the STM32 firmware.
//
// Protocol (reference:kuruma/car_controller_simple.py:306-314 ==
// reference:car/simple_car_controller_stm32.c:38-63):
//   byte 0: 0xAA header
//   byte 1-2: int16 little-endian left wheel speed  (clamped ±1000)
//   byte 3-4: int16 little-endian right wheel speed (clamped ±1000)
//   byte 5: checksum = sum(bytes 1..4) & 0xFF
//   byte 6: 0x55 tail
//
// Three components:
//  1. pack/parse primitives (host side),
//  2. a VehicleSim reproducing the firmware main loop — packet framing,
//     checksum verification, speed clamping, and the 500 ms command
//     watchdog auto-stop (reference:car/simple_car_controller_stm32.c:74-81)
//     — as portable native code for hardware-free integration tests,
//  3. raw-termios serial port I/O for real deployments.
//
// Exposed as a C ABI for ctypes, so that no Python extension is compiled.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <fcntl.h>
#include <termios.h>
#include <unistd.h>
#include <sys/select.h>

namespace {

constexpr uint8_t kHeader = 0xAA;
constexpr uint8_t kTail = 0x55;
constexpr int16_t kMaxSpeed = 1000;

int16_t clamp_speed(int32_t v) {
  if (v > kMaxSpeed) return kMaxSpeed;
  if (v < -kMaxSpeed) return -kMaxSpeed;
  return static_cast<int16_t>(v);
}

uint8_t checksum4(const uint8_t* payload) {
  uint32_t sum = 0;
  for (int i = 0; i < 4; ++i) sum += payload[i];
  return static_cast<uint8_t>(sum & 0xFF);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Packet primitives
// ---------------------------------------------------------------------------

// Pack a 7-byte wheel-speed packet. Speeds are clamped to ±1000 like the
// host controller does before sending. Returns 7.
int sb_pack(int16_t left, int16_t right, uint8_t out[7]) {
  left = clamp_speed(left);
  right = clamp_speed(right);
  out[0] = kHeader;
  out[1] = static_cast<uint8_t>(left & 0xFF);
  out[2] = static_cast<uint8_t>((left >> 8) & 0xFF);
  out[3] = static_cast<uint8_t>(right & 0xFF);
  out[4] = static_cast<uint8_t>((right >> 8) & 0xFF);
  out[5] = checksum4(&out[1]);
  out[6] = kTail;
  return 7;
}

// Validate + unpack a 7-byte packet. Returns 1 on success.
int sb_unpack(const uint8_t in[7], int16_t* left, int16_t* right) {
  if (in[0] != kHeader || in[6] != kTail) return 0;
  if (checksum4(&in[1]) != in[5]) return 0;
  *left = static_cast<int16_t>(in[1] | (in[2] << 8));
  *right = static_cast<int16_t>(in[3] | (in[4] << 8));
  return 1;
}

// ---------------------------------------------------------------------------
// Streaming parser (header-scan state machine; tolerates partial reads and
// garbage between packets — stricter than the firmware's fixed-offset parse,
// same accept set for well-framed streams).
// ---------------------------------------------------------------------------

struct sb_parser_t {
  uint8_t buf[7];
  int fill;
  int16_t last_left, last_right;
  uint32_t packets, checksum_errors, framing_errors;
};

sb_parser_t* sb_parser_new() {
  auto* p = new sb_parser_t();
  std::memset(p, 0, sizeof(*p));
  return p;
}

void sb_parser_free(sb_parser_t* p) { delete p; }

// Feed bytes; returns the number of complete valid packets consumed.
// last packet's speeds are available via sb_parser_last_*.
int sb_parser_feed(sb_parser_t* p, const uint8_t* data, int n) {
  int got = 0;
  for (int i = 0; i < n; ++i) {
    uint8_t b = data[i];
    if (p->fill == 0) {
      if (b == kHeader) p->buf[p->fill++] = b;
      // else: skip garbage silently
      continue;
    }
    p->buf[p->fill++] = b;
    if (p->fill == 7) {
      int16_t l, r;
      if (p->buf[6] != kTail) {
        p->framing_errors++;
        // resync: look for a header inside the buffer
        int next = 1;
        while (next < 7 && p->buf[next] != kHeader) ++next;
        int remain = 7 - next;
        std::memmove(p->buf, p->buf + next, remain);
        p->fill = remain;
        continue;
      }
      if (sb_unpack(p->buf, &l, &r)) {
        p->last_left = clamp_speed(l);
        p->last_right = clamp_speed(r);
        p->packets++;
        got++;
      } else {
        p->checksum_errors++;
      }
      p->fill = 0;
    }
  }
  return got;
}

int16_t sb_parser_last_left(const sb_parser_t* p) { return p->last_left; }
int16_t sb_parser_last_right(const sb_parser_t* p) { return p->last_right; }
uint32_t sb_parser_packets(const sb_parser_t* p) { return p->packets; }
uint32_t sb_parser_checksum_errors(const sb_parser_t* p) { return p->checksum_errors; }
uint32_t sb_parser_framing_errors(const sb_parser_t* p) { return p->framing_errors; }

// ---------------------------------------------------------------------------
// VehicleSim — the firmware main loop as portable native code.
// ---------------------------------------------------------------------------

struct sb_vehicle_t {
  sb_parser_t* parser;
  int16_t left, right;       // current wheel PWM (what TIM_SetCompare gets)
  uint64_t last_command_ms;  // watchdog feed time
  uint32_t timeout_ms;       // 500 in the firmware
  uint32_t watchdog_stops;
};

sb_vehicle_t* sb_vehicle_new(uint32_t timeout_ms) {
  auto* v = new sb_vehicle_t();
  v->parser = sb_parser_new();
  v->left = v->right = 0;
  v->last_command_ms = 0;
  v->timeout_ms = timeout_ms;
  v->watchdog_stops = 0;
  return v;
}

void sb_vehicle_free(sb_vehicle_t* v) {
  sb_parser_free(v->parser);
  delete v;
}

// Feed received bytes at time now_ms; applies any complete speed commands
// (clamped) and feeds the watchdog, mirroring ProcessSpeedCommand
// (reference:car/simple_car_controller_stm32.c:88-146).
int sb_vehicle_feed(sb_vehicle_t* v, const uint8_t* data, int n, uint64_t now_ms) {
  int got = sb_parser_feed(v->parser, data, n);
  if (got > 0) {
    v->left = sb_parser_last_left(v->parser);
    v->right = sb_parser_last_right(v->parser);
    v->last_command_ms = now_ms;
  }
  return got;
}

// One main-loop tick: auto-stop when the command watchdog expires
// (reference:car/simple_car_controller_stm32.c:74-81). Returns 1 if the
// watchdog fired this tick.
int sb_vehicle_tick(sb_vehicle_t* v, uint64_t now_ms) {
  if (now_ms - v->last_command_ms > v->timeout_ms && (v->left != 0 || v->right != 0)) {
    v->left = 0;
    v->right = 0;
    v->watchdog_stops++;
    return 1;
  }
  return 0;
}

int16_t sb_vehicle_left(const sb_vehicle_t* v) { return v->left; }
int16_t sb_vehicle_right(const sb_vehicle_t* v) { return v->right; }
uint32_t sb_vehicle_watchdog_stops(const sb_vehicle_t* v) { return v->watchdog_stops; }
uint32_t sb_vehicle_checksum_errors(const sb_vehicle_t* v) {
  return sb_parser_checksum_errors(v->parser);
}

// ---------------------------------------------------------------------------
// Serial port I/O (raw 8N1 termios)
// ---------------------------------------------------------------------------

static speed_t baud_const(int baud) {
  switch (baud) {
    case 9600: return B9600;
    case 19200: return B19200;
    case 38400: return B38400;
    case 57600: return B57600;
    case 115200: return B115200;
    default: return B115200;
  }
}

int sb_open(const char* device, int baud) {
  int fd = ::open(device, O_RDWR | O_NOCTTY | O_NONBLOCK);
  if (fd < 0) return -1;
  struct termios tio;
  if (tcgetattr(fd, &tio) != 0) {
    ::close(fd);
    return -1;
  }
  cfmakeraw(&tio);
  cfsetispeed(&tio, baud_const(baud));
  cfsetospeed(&tio, baud_const(baud));
  tio.c_cflag |= CLOCAL | CREAD;
  tio.c_cflag &= ~CRTSCTS;
  tio.c_cc[VMIN] = 0;
  tio.c_cc[VTIME] = 0;
  if (tcsetattr(fd, TCSANOW, &tio) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

int sb_send(int fd, int16_t left, int16_t right) {
  // The fd is O_NONBLOCK: a full UART tx buffer surfaces as EAGAIN, which
  // is a transient condition, not an error — wait for writability (up to
  // 50 ms, far under the 500 ms command watchdog) instead of failing the
  // whole control loop over one busy buffer.
  uint8_t pkt[7];
  sb_pack(left, right, pkt);
  int written = 0;
  while (written < 7) {
    ssize_t n = ::write(fd, pkt + written, 7 - written);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
        fd_set wfds;
        FD_ZERO(&wfds);
        FD_SET(fd, &wfds);
        struct timeval tv;
        tv.tv_sec = 0;
        tv.tv_usec = 50 * 1000;
        if (select(fd + 1, nullptr, &wfds, nullptr, &tv) <= 0) return -1;
        continue;
      }
      return -1;
    }
    written += static_cast<int>(n);
  }
  return 7;
}

int sb_read(int fd, uint8_t* buf, int maxlen, int timeout_ms) {
  fd_set rfds;
  FD_ZERO(&rfds);
  FD_SET(fd, &rfds);
  struct timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  int rv = select(fd + 1, &rfds, nullptr, nullptr, &tv);
  if (rv <= 0) return rv;
  ssize_t n = ::read(fd, buf, maxlen);
  return n < 0 ? -1 : static_cast<int>(n);
}

void sb_close(int fd) { ::close(fd); }

}  // extern "C"
