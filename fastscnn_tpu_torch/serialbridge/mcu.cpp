// MCU register layer — the STM32-side motor/USART drivers as buildable,
// hardware-free native code.
//
// The reference keeps this layer as STM32F10x SPL firmware:
//   reference:car/motor.c:5-359   (GPIO/PWM init, speed/direction/differential)
//   reference:car/usart.c:5-71    (USART1 init, IRQ receive ring, RS232 send)
//   reference:car/simple_car_controller_stm32.c:20-156 (main loop: packet
//                                  parse → checksum → signed wheel set → 500 ms
//                                  watchdog)
// which cannot run off-target. This module re-provides the same driver
// semantics against a *mock register file* modeling exactly the peripheral
// state the firmware touches (GPIOA/B output-data registers, TIM3
// ARR/PSC/CCR1..4/CEN, RCC clock enables, USART1 BRR/CR1 + rx ring + tx
// stream), so the register-level contract — which pin goes high, which CCR
// gets which duty for a given command — is testable on any host and the
// logic is one retarget (register-file → volatile MMIO addresses) away from
// real silicon.
//
// Pin map (reference:car/motor.h:9-34):
//   PA0 = right-front dir, PA1 = left-rear dir, PA2 = right-rear dir,
//   PA3 = left-front dir, PA4 = motor enable (ST),
//   TIM3 CCR1/PA6 = right-front PWM, CCR2/PA7 = left-rear PWM,
//   CCR3/PB0 = right-rear PWM, CCR4/PB1 = left-front PWM.
// Forward for a wheel = {RF set, LR set, RR reset, LF reset} per the
// patterns in reference:car/motor.c:115-183.
//
// Documented deviations from the reference source (all are latent reference
// bugs, reproduced here as the *intended* behavior):
//  * usart.h fixes USART1_REC_LEN=5 while the shipped protocol needs 7
//    bytes (reference:car/usart.h:4 vs simple_car_controller_stm32.c:37);
//    the rx ring length is a constructor parameter (0 selects the
//    practical 64-byte default; pass 5 to model the reference bug).
//  * simple_car_controller_stm32.c's `last_command_time` is declared
//    function-static in main() but assigned in ProcessSpeedCommand (would
//    not compile); here the watchdog timestamp is explicit MCU state.
//  * usart.c's IRQ handler silently drops 0xFF bytes
//    (reference:car/usart.c:63), but 0xFF is a legal payload byte of the
//    7-byte protocol (high byte of any negative int16 speed); the drop is
//    opt-in here and off for the firmware path.
//  * SetWheelSpeeds maps CCR1/2 to the LEFT pwm and CCR3/4 to the RIGHT
//    (simple_car_controller_stm32.c:137-140) even though motor.h wires
//    CCR1 to the right-front wheel; we follow motor.h's wiring (CCR1/3 =
//    right side) so differential commands steer the correct way.
//
// C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// Register file
// ---------------------------------------------------------------------------

constexpr uint32_t kPinRF = 1u << 0;  // PA0 right-front direction
constexpr uint32_t kPinLR = 1u << 1;  // PA1 left-rear direction
constexpr uint32_t kPinRR = 1u << 2;  // PA2 right-rear direction
constexpr uint32_t kPinLF = 1u << 3;  // PA3 left-front direction
constexpr uint32_t kPinST = 1u << 4;  // PA4 motor enable

constexpr uint32_t kRccGpioA = 1u << 2;   // APB2ENR IOPAEN
constexpr uint32_t kRccGpioB = 1u << 3;   // APB2ENR IOPBEN
constexpr uint32_t kRccUsart1 = 1u << 14; // APB2ENR USART1EN
constexpr uint32_t kRccTim3 = 1u << 1;    // APB1ENR TIM3EN

constexpr uint32_t kUsartCr1Ue = 1u << 13;    // USART enable
constexpr uint32_t kUsartCr1RxneIe = 1u << 5; // RXNE interrupt enable

constexpr int kMaxPwm = 1000;
constexpr int kTxLogCap = 1024;
constexpr int kRxCap = 64;

// Wheel indices for the accessor API.
enum Wheel { kRightFront = 0, kLeftRear = 1, kRightRear = 2, kLeftFront = 3 };

// Direction commands (reference:car/motor.h:37-40).
enum Dir { kDirForward = 0, kDirBack = 1, kDirLeft = 2, kDirRight = 3 };

struct mcu_t {
  // GPIO output data registers.
  uint32_t gpioa_odr = 0;
  uint32_t gpiob_odr = 0;
  // TIM3 (PWM) registers.
  uint32_t tim3_arr = 0;
  uint32_t tim3_psc = 0;
  uint32_t tim3_ccr[4] = {0, 0, 0, 0};  // CCR1..CCR4
  uint8_t tim3_cen = 0;
  // Clock enables.
  uint32_t rcc_apb2enr = 0;
  uint32_t rcc_apb1enr = 0;
  // USART1.
  uint32_t usart_brr = 0;
  uint32_t usart_cr1 = 0;
  uint8_t rx_buf[kRxCap];
  uint8_t rx_len = 0;
  uint8_t rx_cap = kRxCap;
  uint8_t drop_ff = 0;
  uint8_t tx_log[kTxLogCap];
  int tx_len = 0;
  // Driver state.
  uint16_t g_speed = 500;  // reference:car/motor.c:3
  // Firmware main-loop state.
  int16_t left_speed = 0;
  int16_t right_speed = 0;
  uint8_t motor_enabled = 0;
  uint64_t last_command_ms = 0;
  uint32_t watchdog_stops = 0;
  uint32_t checksum_errors = 0;
  uint32_t protocol_errors = 0;
};

uint16_t clamp_pwm(uint32_t v) { return v > kMaxPwm ? kMaxPwm : static_cast<uint16_t>(v); }

int16_t clamp_speed(int32_t v) {
  if (v > kMaxPwm) return kMaxPwm;
  if (v < -kMaxPwm) return -kMaxPwm;
  return static_cast<int16_t>(v);
}

void set_ccr_all(mcu_t* m, uint16_t rf, uint16_t lr, uint16_t rr, uint16_t lf) {
  m->tim3_ccr[kRightFront] = rf;
  m->tim3_ccr[kLeftRear] = lr;
  m->tim3_ccr[kRightRear] = rr;
  m->tim3_ccr[kLeftFront] = lf;
}

// The all-forward direction pattern (reference:car/motor.c:116-121 et al.).
void set_dir_forward(mcu_t* m) {
  m->gpioa_odr |= (kPinRF | kPinLR);
  m->gpioa_odr &= ~(kPinRR | kPinLF);
}

void set_dir_back(mcu_t* m) {
  m->gpioa_odr &= ~(kPinRF | kPinLR);
  m->gpioa_odr |= (kPinRR | kPinLF);
}

void tx_append(mcu_t* m, const uint8_t* buf, int len) {
  for (int i = 0; i < len && m->tx_len < kTxLogCap; ++i) m->tx_log[m->tx_len++] = buf[i];
}

}  // namespace

extern "C" {

mcu_t* mcu_new(int rx_ring_len) {
  auto* m = new mcu_t();
  if (rx_ring_len > 0 && rx_ring_len <= kRxCap)
    m->rx_cap = static_cast<uint8_t>(rx_ring_len);
  return m;
}

void mcu_free(mcu_t* m) { delete m; }

// ---------------------------------------------------------------------------
// motor driver (reference:car/motor.c semantics)
// ---------------------------------------------------------------------------

void mcu_motor_gpio_init(mcu_t* m) {
  // RCC clocks + direction/enable pins configured as push-pull outputs
  // (mode bits are not modeled; the observable contract is the ODR).
  m->rcc_apb2enr |= kRccGpioA | kRccGpioB;
}

void mcu_motor_pwm_init(mcu_t* m) {
  // TIM3: 72 MHz / 72 / 1000 = 1 kHz PWM, duty unit = 1/1000
  // (reference:car/motor.c:63-65).
  m->rcc_apb2enr |= kRccGpioA | kRccGpioB;
  m->rcc_apb1enr |= kRccTim3;
  m->tim3_arr = 1000 - 1;
  m->tim3_psc = 72 - 1;
  for (int i = 0; i < 4; ++i) m->tim3_ccr[i] = m->g_speed;
  m->tim3_cen = 1;
}

void mcu_motor_set_speed(mcu_t* m, uint32_t speed) {
  uint16_t s = clamp_pwm(speed);
  m->g_speed = s;
  set_ccr_all(m, s, s, s, s);
}

void mcu_motor_enable(mcu_t* m, int enable) {
  if (enable)
    m->gpioa_odr |= kPinST;
  else
    m->gpioa_odr &= ~kPinST;
  m->motor_enabled = enable ? 1 : 0;
}

// Motor_SetDirection: stored g_speed, 25% inner wheel on turns
// (reference:car/motor.c:112-183).
void mcu_motor_set_direction(mcu_t* m, int dir) {
  uint16_t s = m->g_speed;
  switch (dir) {
    case kDirForward:
      set_dir_forward(m);
      set_ccr_all(m, s, s, s, s);
      break;
    case kDirBack:
      set_dir_back(m);
      set_ccr_all(m, s, s, s, s);
      break;
    case kDirLeft: {  // right side 100%, left side 25%
      set_dir_forward(m);
      uint16_t inner = static_cast<uint16_t>(s * 1 / 4);
      set_ccr_all(m, s, inner, s, inner);
      break;
    }
    case kDirRight: {  // left side 100%, right side 25%
      set_dir_forward(m);
      uint16_t inner = static_cast<uint16_t>(s * 1 / 4);
      set_ccr_all(m, inner, s, inner, s);
      break;
    }
    default:
      break;
  }
}

// Motor_SetDirectionWithSpeed: explicit speed; the reference's turn cases
// compute `speed * 0 / 10` — a hard-stopped inner wheel (the comment says
// 20%, the code says 0; we reproduce the code:
// reference:car/motor.c:228,247).
void mcu_motor_set_direction_with_speed(mcu_t* m, int dir, uint32_t speed) {
  uint16_t s = clamp_pwm(speed);
  switch (dir) {
    case kDirForward:
      set_dir_forward(m);
      set_ccr_all(m, s, s, s, s);
      break;
    case kDirBack:
      set_dir_back(m);
      set_ccr_all(m, s, s, s, s);
      break;
    case kDirLeft:
      set_dir_forward(m);
      set_ccr_all(m, s, 0, s, 0);
      break;
    case kDirRight:
      set_dir_forward(m);
      set_ccr_all(m, 0, s, 0, s);
      break;
    default:
      break;
  }
}

// Motor_SetDifferentialSpeed: unsigned left/right duty, all-forward
// (reference:car/motor.c:306-324).
void mcu_motor_set_differential(mcu_t* m, uint32_t left, uint32_t right) {
  uint16_t l = clamp_pwm(left);
  uint16_t r = clamp_pwm(right);
  set_dir_forward(m);
  set_ccr_all(m, r, l, r, l);
}

// ---------------------------------------------------------------------------
// USART driver (reference:car/usart.c semantics)
// ---------------------------------------------------------------------------

void mcu_usart_init(mcu_t* m, uint32_t baud) {
  m->rcc_apb2enr |= kRccGpioA | kRccUsart1;
  m->usart_brr = baud;
  m->usart_cr1 = kUsartCr1Ue | kUsartCr1RxneIe;
  m->rx_len = 0;
}

// The RXNE IRQ handler: append, wrap at the ring length
// (reference:car/usart.c:56-71). The reference unconditionally drops
// 0xFF bytes — a latent bug for the shipped 7-byte protocol, whose int16
// payloads legally contain 0xFF (every negative speed's high byte). The
// drop is therefore opt-in (`mcu_usart_set_drop_ff`) to model the
// reference byte-for-byte; the firmware path leaves it off.
void mcu_usart_irq_rx(mcu_t* m, uint8_t byte) {
  if (!(m->usart_cr1 & kUsartCr1Ue)) return;
  if (m->drop_ff && byte == 0xFF) return;
  m->rx_buf[m->rx_len++] = byte;
  if (m->rx_len >= m->rx_cap) m->rx_len = 0;
}

void mcu_rs232_send(mcu_t* m, const uint8_t* buf, int len) { tx_append(m, buf, len); }

void mcu_usart_set_drop_ff(mcu_t* m, int enable) { m->drop_ff = enable ? 1 : 0; }

// ---------------------------------------------------------------------------
// Firmware main loop (reference:car/simple_car_controller_stm32.c:20-156)
// ---------------------------------------------------------------------------

// Signed wheel set: per the wiring table, both sides share the 4 direction
// pins; PWM = |speed| per side. Status echo over RS232 like the firmware.
void mcu_set_wheel_speeds(mcu_t* m, int left, int right) {
  int16_t l = clamp_speed(left);
  int16_t r = clamp_speed(right);
  m->left_speed = l;
  m->right_speed = r;
  if (l >= 0 && r >= 0)
    set_dir_forward(m);
  else if (l < 0 && r < 0)
    set_dir_back(m);
  else {
    // Spin: left and right sides opposite; per-side direction bits.
    if (l >= 0) {
      m->gpioa_odr |= kPinLR;
      m->gpioa_odr &= ~kPinLF;
    } else {
      m->gpioa_odr &= ~kPinLR;
      m->gpioa_odr |= kPinLF;
    }
    if (r >= 0) {
      m->gpioa_odr |= kPinRF;
      m->gpioa_odr &= ~kPinRR;
    } else {
      m->gpioa_odr &= ~kPinRF;
      m->gpioa_odr |= kPinRR;
    }
  }
  uint16_t lp = static_cast<uint16_t>(l < 0 ? -l : l);
  uint16_t rp = static_cast<uint16_t>(r < 0 ? -r : r);
  set_ccr_all(m, rp, lp, rp, lp);
  char msg[64];
  int n = std::snprintf(msg, sizeof(msg), "Speed: L=%d R=%d\r\n", l, r);
  tx_append(m, reinterpret_cast<const uint8_t*>(msg), n);
}

// Boot sequence: init drivers, enable motors, announce readiness
// (reference:car/simple_car_controller_stm32.c:20-33).
void mcu_firmware_boot(mcu_t* m) {
  mcu_motor_gpio_init(m);
  mcu_motor_pwm_init(m);
  mcu_usart_init(m, 115200);
  mcu_motor_enable(m, 1);
  mcu_set_wheel_speeds(m, 0, 0);
  static const char ready[] = "Simple Car Controller Ready\r\n";
  tx_append(m, reinterpret_cast<const uint8_t*>(ready), sizeof(ready) - 1);
}

namespace {

// Fixed-offset frame parse from the front of the rx ring
// (reference:car/simple_car_controller_stm32.c:38-63). Returns 1 if a
// speed command was applied.
int parse_front_frame(mcu_t* m, uint64_t now_ms);

}  // namespace

// One pass of the firmware main loop at time now_ms: feed pending bytes
// through the RXNE IRQ, parsing a complete 7-byte frame whenever one is
// buffered (the real main loop spins far faster than 115200-baud bytes
// arrive, so it always drains the ring before the wrap-at-capacity
// overflow guard can fire), then run the 500 ms command watchdog.
// Returns the number of speed commands applied.
int mcu_firmware_poll(mcu_t* m, const uint8_t* data, int n, uint64_t now_ms) {
  int applied = 0;
  for (int i = 0; i < n; ++i) {
    mcu_usart_irq_rx(m, data[i]);
    if (m->rx_len >= 7) applied += parse_front_frame(m, now_ms);
  }
  if (now_ms - m->last_command_ms > 500 && (m->left_speed != 0 || m->right_speed != 0)) {
    mcu_set_wheel_speeds(m, 0, 0);
    ++m->watchdog_stops;
  }
  return applied;
}

namespace {

int parse_front_frame(mcu_t* m, uint64_t now_ms) {
  int applied = 0;
  {
    const uint8_t* rx = m->rx_buf;
    if (rx[0] == 0xAA && rx[6] == 0x55) {
      int16_t l = static_cast<int16_t>((rx[2] << 8) | rx[1]);
      int16_t r = static_cast<int16_t>((rx[4] << 8) | rx[3]);
      uint8_t sum = 0;
      for (int k = 1; k <= 4; ++k) sum = static_cast<uint8_t>(sum + rx[k]);
      if (sum == rx[5]) {
        mcu_set_wheel_speeds(m, l, r);
        m->last_command_ms = now_ms;
        ++applied;
      } else {
        ++m->checksum_errors;
        static const char err[] = "Checksum Error\r\n";
        tx_append(m, reinterpret_cast<const uint8_t*>(err), sizeof(err) - 1);
      }
    } else {
      ++m->protocol_errors;
      static const char err[] = "Protocol Error\r\n";
      tx_append(m, reinterpret_cast<const uint8_t*>(err), sizeof(err) - 1);
    }
    // The firmware clears the whole ring after each parse attempt
    // (simple_car_controller_stm32.c:70); keep any over-read bytes so
    // back-to-back packets in one poll are not dropped.
    int remain = m->rx_len - 7;
    std::memmove(m->rx_buf, m->rx_buf + 7, remain > 0 ? remain : 0);
    m->rx_len = static_cast<uint8_t>(remain > 0 ? remain : 0);
  }
  return applied;
}

}  // namespace

// ---------------------------------------------------------------------------
// Register accessors (the register-mock test surface)
// ---------------------------------------------------------------------------

uint32_t mcu_gpioa_odr(const mcu_t* m) { return m->gpioa_odr; }
uint32_t mcu_gpiob_odr(const mcu_t* m) { return m->gpiob_odr; }
uint32_t mcu_tim3_arr(const mcu_t* m) { return m->tim3_arr; }
uint32_t mcu_tim3_psc(const mcu_t* m) { return m->tim3_psc; }
uint32_t mcu_tim3_ccr(const mcu_t* m, int channel) {
  return (channel >= 1 && channel <= 4) ? m->tim3_ccr[channel - 1] : 0;
}
int mcu_tim3_enabled(const mcu_t* m) { return m->tim3_cen; }
uint32_t mcu_rcc_apb2enr(const mcu_t* m) { return m->rcc_apb2enr; }
uint32_t mcu_rcc_apb1enr(const mcu_t* m) { return m->rcc_apb1enr; }
uint32_t mcu_usart_brr(const mcu_t* m) { return m->usart_brr; }
int mcu_rx_len(const mcu_t* m) { return m->rx_len; }

// Drain the RS232 transmit log (status echoes). Returns bytes copied.
int mcu_read_tx(mcu_t* m, uint8_t* out, int maxlen) {
  int n = m->tx_len < maxlen ? m->tx_len : maxlen;
  std::memcpy(out, m->tx_log, n);
  std::memmove(m->tx_log, m->tx_log + n, m->tx_len - n);
  m->tx_len -= n;
  return n;
}

// Signed per-wheel velocity derived from the direction ODR bit + CCR duty:
// what the physical wheel does. wheel: 0=RF 1=LR 2=RR 3=LF.
int mcu_wheel_velocity(const mcu_t* m, int wheel) {
  if (wheel < 0 || wheel > 3) return 0;
  int duty = static_cast<int>(m->tim3_ccr[wheel]);
  uint32_t pin[4] = {kPinRF, kPinLR, kPinRR, kPinLF};
  bool bit = (m->gpioa_odr & pin[wheel]) != 0;
  // Forward = bit set for RF/LR, bit clear for RR/LF (motor.c patterns).
  bool forward = (wheel == kRightFront || wheel == kLeftRear) ? bit : !bit;
  return forward ? duty : -duty;
}

int16_t mcu_left_speed(const mcu_t* m) { return m->left_speed; }
int16_t mcu_right_speed(const mcu_t* m) { return m->right_speed; }
uint32_t mcu_watchdog_stops(const mcu_t* m) { return m->watchdog_stops; }
uint32_t mcu_checksum_errors(const mcu_t* m) { return m->checksum_errors; }
uint32_t mcu_protocol_errors(const mcu_t* m) { return m->protocol_errors; }
int mcu_motor_is_enabled(const mcu_t* m) { return m->motor_enabled; }

}  // extern "C"
