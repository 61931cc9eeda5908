// KJ: the vehicle force models (car, bike, boat, hovercar), one block of
// four warps per vehicle, the wheels and the controllers side by side.
//
// Replaces substrata_tpu/physics/vehicles/manager.py:_vehicle_update_one
// (:298-594), the body of the vmap at :637-649; plain twin:
// substrata_tpu_torch/kernels/vehicles.py:vehicle_forces_plain.  A vehicle
// reads its chassis state, its wheel-ray hits (kernel KH) and its vehicle
// row, and writes the chassis velocity deltas and the new controller state
// (steering, suspension length, wheel spin and rotation, unflip time,
// contact, gear, shift timer, rpm).  jnp.interp and the one-hot gear select
// become short table walks.
//
// What bounds it on the card: latency.  Eight vehicles are far below a
// microsecond of the card's bytes and operations; the cost is the chain of
// a vehicle's ~3,000 dependent float operations (four wheels, then each
// controller) if one thread walks it.  The parts that do not feed each
// other run at once instead:
//
//   warp 0   lanes 0-3: wheels 0-3 (suspension, tyre forces, force_at, spin
//            state), each after the drivetrain, which every lane of the
//            warp computes alike; lane 0 writes the drivetrain's outputs;
//   warp 1   lane 0: the keep-upright controller, computed once (the
//            reference calls it twice with the same arguments: for the
//            hovercar and for a wheeled vehicle's righting);
//   warp 2   lane 0: the hovercar, then the boat's water drag;
//   warp 3   lane 0: the bike's lean, then the boat's thrust and rudder.
//
// Divergent lanes of one warp would run their paths one after the other,
// so each path has a warp of its own.  Every lane issues the loads its path
// needs at its top, before any use; the vehicle's common fields are
// broadcasts, one transaction a warp.  Each path leaves its (dv, dw) terms
// in shared memory, already selected by its gate, and lanes 0-2 of warp 0
// fold component k of dv and dw in the order the reference adds them: the
// wheels ((0 + w0) + w1) + w2) + w3, the lean, the boat's zero term and the
// boat, the drag, the hovercar, the righting.  The library is built with
// -fmad=false, so every path's operations round as written (the cross and
// dot products, norms and Iw products as the jitted reference contracts
// them: cross_fma, dot3_fma, mv_fma), whichever lane
// runs them, and the fold's order fixes the sums' rounding.  Each output is
// written once, by the lane that owns it.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kCar = 0, kBike = 1, kBoat = 2, kHover = 3;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kRpmPerRadS = 9.549296585513721f;    // 60 / (2 pi)
constexpr float kDeg = 57.29577951308232f;            // 180 / pi
constexpr int kWarps = 4;                             // a vehicle's block
__constant__ float kBikeGears[6] = {2.27f, 1.63f, 1.30f, 1.09f, 0.96f, 0.88f};
__constant__ float kCarGears[6] = {2.66f, 1.78f, 1.30f, 1.0f, 0.74f, 0.74f};

// The launcher's inputs, in kernels/vehicles.py:_Plan.NAMES order: the 33
// vehicle fields (KERNEL_FIELDS), the 5 inputs, then the chassis rows, the
// wheel hits and the water level.
enum In {
  kVtype, kActive, kYq, kAttach, kRad, kNw, kSusMin, kSusMax, kSpringFreq, kSpringDamp,
  kMaxSteer, kEngTorque, kEngMaxRpm, kBrakeTorque, kHandbrakeTorque, kMuLong, kMuLat,
  kSteerRelax, kLeanSpring, kLeanDamp, kThrustForce, kPropOs, kRudder, kThrustLat, kAreas,
  kSteering, kPrevSus, kOmega, kRot, kUnflip, kRighting, kGear, kShiftTimer, kInFwd, kInRight,
  kInUp, kInBrake, kInHandbrake, kPos, kQuat, kLin, kAng, kMass, kIw, kHitT, kHitN, kHitOk,
  kWaterZ, kNumIn
};

// The output buffer (kernels/vehicles.py:_views): each output's first
// float, in units of V floats; gear is int32 and contact bool [V, 4] in
// their floats' bytes.
enum Out {
  kODv = 0, kODw = 3, kOSteering = 6, kOSusLen = 7, kOOmega = 11, kORot = 15, kOUnflip = 19,
  kOShiftTimer = 20, kORpm = 21, kOGear = 22, kOContact = 23
};

struct VehicleArgs {
  const void* in[kNumIn];
  float* out;
  int V;
  float dt;
};

// Each term's three components in a block's shared memory.
enum Term {
  kWheelDv0, kWheelDw0 = kWheelDv0 + 4, kLean = kWheelDw0 + 4, kBoatZero, kBoatDv, kBoatDw,
  kDrag, kHoverDv, kHoverDw, kRightDw, kTerms
};

template <class T>
__device__ __forceinline__ const T* in(const VehicleArgs& a, int k) {
  return static_cast<const T*>(a.in[k]);
}

__device__ __forceinline__ float signf_(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// kernels/vehicles.py:_interp3 (jnp.interp over three ascending points).
__device__ float interp3(float x, float x0, float x1, float x2, float f0, float f1, float f2) {
  const bool upper = x >= x1;
  const float x_lo = upper ? x1 : x0;
  const float dx = upper ? x2 - x1 : x1 - x0;
  const float f_lo = upper ? f1 : f0;
  const float f_hi = upper ? f2 : f1;
  float f = f_lo + (x - x_lo) / dx * (f_hi - f_lo);
  if (x < x0) f = f0;
  if (x > x2) f = f2;
  return f;
}

// maths/quat.py:mul
__device__ void qmul(const float a[4], const float b[4], float o[4]) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

struct Chassis {
  float pos[3], q[4], lin[3], ang[3], mass, iw[3][3], dt, dt_m;
};

// kernels/vehicles.py:righting_torque_dv
__device__ void righting(const Chassis& c, const float yq[4], float out[3]) {
  const float ex[3] = {1.0f, 0.0f, 0.0f};
  const float yqc[4] = {-yq[0], -yq[1], -yq[2], yq[3]};
  float r_os[3], r_ws[3];
  sbt::rotate_vec(yqc, ex, r_os);
  sbt::rotate_vec(c.q, r_os, r_ws);
  const float yaw = atan2f(r_ws[1], r_ws[0]);
  const float half = 0.5f * yaw;
  const float s = sinf(half);
  const float aq[4] = {0.0f * s, 0.0f * s, 1.0f * s, cosf(half)};
  const float qc[4] = {-c.q[0], -c.q[1], -c.q[2], c.q[3]};
  float desired[4], cur[4];
  qmul(aq, yq, desired);
  qmul(desired, qc, cur);
  if (cur[3] < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = -cur[k];
  }
  const float v3[3] = {cur[0], cur[1], cur[2]};
  const float sin_half = sqrtf(sbt::dot3_fma(v3, v3));
  const float angle = 2.0f * atan2f(sin_half, cur[3]);
  const float safe = fmaxf(sin_half, 1e-12f);
  float torque[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float axis = sin_half < 1e-8f ? ex[k] : cur[k] / safe;
    torque[k] = (axis * angle * 3.0f - c.ang[k]) * c.mass * 1.5f;
  }
  sbt::mv_fma(c.iw, torque, out);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = out[k] * c.dt;
}

// (dv, dw) of one force at a world point (manager.py:add_force_at).
__device__ void force_at(const Chassis& c, const float f[3], const float point[3], float dv[3],
                         float dw[3]) {
  const float r[3] = {point[0] - c.pos[0], point[1] - c.pos[1], point[2] - c.pos[2]};
  float tau[3];
  sbt::cross_fma(r, f, tau);
  sbt::mv_fma(c.iw, tau, dw);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dv[k] = f[k] * c.dt_m;
    dw[k] = dw[k] * c.dt;
  }
}

__device__ __forceinline__ void put(float (*t)[3], int term, const float x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) t[term][k] = x[k];
}

// Steering smoothing: every path that reads the new angle computes it.
__device__ __forceinline__ float new_steering(const VehicleArgs& a, int v, bool wheeled_active,
                                              float right_in) {
  const float target = -right_in * in<float>(a, kMaxSteer)[v];
  const float relax = in<float>(a, kSteerRelax)[v];
  const float steering = in<float>(a, kSteering)[v];
  const float step = fminf(fmaxf(target - steering, -relax * a.dt), relax * a.dt);
  return wheeled_active ? steering + step : 0.0f;
}

// Warp 0: the drivetrain, then lane w < 4 runs wheel w.
__device__ void wheels(const VehicleArgs& a, int v, int lane, const Chassis& c, int vt,
                       bool active, float fwd_in, float right_in, const float fwd_w[3],
                       const float right_w[3], const float up_w[3], float (*terms)[3]) {
  const int w = lane & 3;
  const int r4 = v * 4 + w;
  // Every load of this lane's path, before any use.
  const float rad = in<float>(a, kRad)[v];
  const int gear = in<int>(a, kGear)[v];
  const float timer = in<float>(a, kShiftTimer)[v];
  const float max_rpm = in<float>(a, kEngMaxRpm)[v];
  const float eng_torque = in<float>(a, kEngTorque)[v];
  const bool brake_in = in<bool>(a, kInBrake)[v];
  const bool handbrake_in = in<bool>(a, kInHandbrake)[v];
  const int nw = in<int>(a, kNw)[v];
  const float spring_freq = in<float>(a, kSpringFreq)[v];
  const float spring_damping = in<float>(a, kSpringDamp)[v];
  const float smin = in<float>(a, kSusMin)[v], smax = in<float>(a, kSusMax)[v];
  const float mu_long = in<float>(a, kMuLong)[v];
  const float ml = in<float>(a, kMuLat)[v];
  const float brake_torque = in<float>(a, kBrakeTorque)[v];
  const float handbrake_torque = in<float>(a, kHandbrakeTorque)[v];
  const float ht = in<float>(a, kHitT)[r4];
  const float n[3] = {in<float>(a, kHitN)[r4 * 3 + 0], in<float>(a, kHitN)[r4 * 3 + 1],
                      in<float>(a, kHitN)[r4 * 3 + 2]};
  const bool hit_ok = in<bool>(a, kHitOk)[r4];
  const float wa[3] = {in<float>(a, kAttach)[r4 * 3 + 0], in<float>(a, kAttach)[r4 * 3 + 1],
                       in<float>(a, kAttach)[r4 * 3 + 2]};
  const float prev_sus = in<float>(a, kPrevSus)[r4];
  const float omega_in = in<float>(a, kOmega)[r4];
  const float rot_in = in<float>(a, kRot)[r4];

  const float dt = c.dt;
  const float mass = c.mass;
  const bool is_wheeled = vt == kCar || vt == kBike;
  const bool is_bike = vt == kBike;
  const float steer = new_steering(a, v, is_wheeled && active, right_in);

  // Drivetrain state shared by the wheels.
  const float speed_fwd = sbt::dot3_fma(c.lin, fwd_w);
  const float omega_avg = fabsf(speed_fwd) / rad;
  const bool in_reverse = fwd_in < -0.01f && speed_fwd < 0.5f;
  const bool brake_from_input = fwd_in < -0.01f && speed_fwd >= 0.5f;
  const int max_gear = is_bike ? 5 : 4;
  const float shift_up_rpm = is_bike ? 9000.0f : 4000.0f;
  const float shift_down_rpm = is_bike ? 5000.0f : 2000.0f;
  const float switch_time = is_bike ? 0.2f : 0.5f;
  const float ratio_fwd = (gear >= 0 && gear < 6) ? (is_bike ? kBikeGears[gear] : kCarGears[gear]) : 0.0f;
  const float ratio = (in_reverse ? -2.90f : ratio_fwd) * 3.42f;
  const float rpm_raw = fabsf(omega_avg) * fabsf(ratio) * kRpmPerRadS;
  const float new_rpm = fminf(fmaxf(rpm_raw, 1000.0f), max_rpm);
  const bool can_shift = timer <= 0.0f;
  const bool shift_up = can_shift && !in_reverse && rpm_raw > shift_up_rpm && gear < max_gear;
  const bool shift_down = can_shift && !in_reverse && rpm_raw < shift_down_rpm && gear > 0;
  const int new_gear = gear + (shift_up ? 1 : 0) - (shift_down ? 1 : 0);
  const float new_timer = (shift_up || shift_down) ? switch_time : fmaxf(timer - dt, 0.0f);
  const bool clutch = timer <= 0.0f;
  const float throttle = fabsf(fwd_in);
  float t_norm = interp3(new_rpm / fmaxf(max_rpm, 1.0f), 0.0f, 0.66f, 1.0f, 0.8f, 1.0f, 0.8f);
  if (rpm_raw >= max_rpm) t_norm = 0.0f;
  const float t_engine = eng_torque * t_norm * throttle;
  const float t_wheel = t_engine * ratio * (is_bike ? 1.0f : 0.5f);
  const bool driving = clutch && !brake_from_input && throttle > 0.01f;
  const bool braking = brake_in || brake_from_input;
  const bool coasting = fabsf(fwd_in) < 0.01f && clutch;
  const float engine_omega = new_rpm / kRpmPerRadS;

  float* out = a.out;
  const int V = a.V;
  if (lane == 0) {
    out[kOSteering * V + v] = steer;
    out[kOShiftTimer * V + v] = is_wheeled ? new_timer : timer;
    out[kORpm * V + v] = is_wheeled ? new_rpm : 0.0f;
    reinterpret_cast<int*>(out + kOGear * V)[v] = (is_wheeled && active) ? new_gear : gear;
  }
  if (lane >= 4) return;

  const float m_quarter = mass / fmaxf(static_cast<float>(nw), 1.0f);
  const float sp = kTwoPi * spring_freq;
  const float k_spring = m_quarter * (sp * sp);
  const float c_damp = spring_damping * 2.0f * sqrtf(k_spring * m_quarter);
  const float ray_len = smax + rad;
  const float mu_pk = is_bike ? 8.0f : 1.2f * mu_long;
  const float mu_sl = is_bike ? 3.0f : 1.0f * mu_long;
  const float mu0 = is_bike ? 0.0f : 0.0f * ml;
  const float mu1 = is_bike ? 3.6f : 1.2f * ml;
  const float mu2 = is_bike ? 2.0f : 1.0f * ml;
  const float ca = cosf(steer), sa = sinf(steer);
  const float omega_cap = (max_rpm / kRpmPerRadS) / fmaxf(fabsf(ratio), 0.1f);

  float att[3];
  sbt::rotate_vec(c.q, wa, att);
  const bool hit = hit_ok && w < nw && ht <= ray_len;
  const float sus_len = fminf(fmaxf(ht - rad, smin), smax);
  const float compression = smax - sus_len;
  const float comp_rate = (prev_sus - sus_len) / dt;
  const float f_spring = fmaxf(k_spring * compression + c_damp * comp_rate, 0.0f);
  const float load = hit ? f_spring : 0.0f;
  float contact[3], rel[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    contact[k] = (c.pos[k] + att[k]) + -up_w[k] * ht;
    rel[k] = contact[k] - c.pos[k];
  }
  const bool is_front = is_bike ? w == 0 : w < 2;
  float wf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) wf[k] = is_front ? fwd_w[k] * ca - right_w[k] * sa : fwd_w[k];
  const float dn = sbt::dot3_fma(wf, n);
  float wfl[3], wlat[3], vc[3], v_cp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) wfl[k] = wf[k] - n[k] * dn;
  const float wn = fmaxf(sqrtf(sbt::dot3_fma(wfl, wfl)), 1e-6f);
#pragma unroll
  for (int k = 0; k < 3; ++k) wfl[k] = wfl[k] / wn;
  sbt::cross_fma(n, wfl, wlat);
  sbt::cross_fma(c.ang, rel, vc);
#pragma unroll
  for (int k = 0; k < 3; ++k) v_cp[k] = c.lin[k] + vc[k];
  const float v_long = sbt::dot3_fma(v_cp, wfl);
  const float v_lat = sbt::dot3_fma(v_cp, wlat);

  const bool driven = is_bike ? w == 1 : w < 2;
  const float f_drive = (driven && hit && driving) ? t_wheel / rad : 0.0f;
  const float f_eng = (driven && coasting) ? 0.1f * engine_omega * fabsf(ratio) / rad : 0.0f;
  float f_cap = ((handbrake_in && w >= 2) ? handbrake_torque
                                           : (braking ? brake_torque : 0.0f)) / rad;
  f_cap = f_cap + f_eng;
  const float f_brake = -signf_(v_long) * fminf(f_cap, fabsf(v_long) * m_quarter / dt);
  const float f_long_want = f_drive + (hit ? f_brake : 0.0f);
  const float f_lat_want = -v_lat * m_quarter / dt;
  const float f_peak = mu_pk * load;
  const float f_slide = mu_sl * load;
  const bool spinning = fabsf(f_long_want) > f_peak;
  const float f_long_max = spinning ? f_slide : f_peak;
  const float f_long = fminf(fmaxf(f_long_want, -f_long_max), f_long_max);
  const float slip_deg = atan2f(fabsf(v_lat), fmaxf(fabsf(v_long), 0.3f)) * kDeg;
  const float mu_lat = interp3(slip_deg, 0.0f, 3.0f, 20.0f, mu0, mu1, mu2);
  const float f_lat = fminf(fmaxf(f_lat_want, -mu_lat * load), mu_lat * load);

  float force[3], dv[3], dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float fk = -up_w[k] * -f_spring + wfl[k] * f_long + wlat[k] * f_lat;
    force[k] = hit ? fk : 0.0f;
  }
  force_at(c, force, contact, dv, dw);
  put(terms, kWheelDv0 + w, dv);
  put(terms, kWheelDw0 + w, dw);

  // Wheel spin, contact and suspension state.
  const float excess = fmaxf(fabsf(f_long_want) - f_slide, 0.0f) * rad;
  float spin = omega_in + signf_(f_long_want) * excess / 0.9f * dt;
  spin = fminf(fmaxf(spin, -omega_cap), omega_cap);
  const float omega = (hit && spinning && driven) ? spin
                      : (hit ? v_long / rad : omega_in * 0.95f);
  out[kOOmega * V + r4] = omega;
  out[kORot * V + r4] = rot_in + omega * dt;
  out[kOSusLen * V + r4] = sus_len;
  reinterpret_cast<bool*>(out + kOContact * V)[r4] = hit;
}

// Warp 3, lane 0: the bike's lean controller (a PD toward the
// centripetal-balance lean angle), then the boat's thrust and rudder at the
// propeller while it is under water.
__device__ void lean_and_boat(const VehicleArgs& a, int v, const Chassis& c, int vt,
                              bool active, float fwd_in, float right_in, float water_z,
                              const float fwd_w[3], const float right_w[3],
                              const float up_w[3], float (*terms)[3]) {
  const float attach_y0 = in<float>(a, kAttach)[v * 12 + 1];
  const float attach_y1 = in<float>(a, kAttach)[v * 12 + 4];
  const float lean_spring = in<float>(a, kLeanSpring)[v];
  const float lean_damping = in<float>(a, kLeanDamp)[v];
  const float po[3] = {in<float>(a, kPropOs)[v * 3 + 0], in<float>(a, kPropOs)[v * 3 + 1],
                       in<float>(a, kPropOs)[v * 3 + 2]};
  const float thrust_lat = in<float>(a, kThrustLat)[v];
  const float thrust_force = in<float>(a, kThrustForce)[v];
  const float rudder_factor = in<float>(a, kRudder)[v];
  const float dt = c.dt, mass = c.mass;
  const bool is_wheeled = vt == kCar || vt == kBike;
  const bool is_bike = vt == kBike;
  const float steer = new_steering(a, v, is_wheeled && active, right_in);
  const float speed_fwd = sbt::dot3_fma(c.lin, fwd_w);
  {
    const float wheelbase = fmaxf(fabsf(attach_y0 - attach_y1), 0.5f);
    const float yaw_rate = speed_fwd * tanf(steer) / wheelbase;
    const float lean_target = fminf(fmaxf(atan2f(speed_fwd * yaw_rate, 9.81f), -0.9f), 0.9f);
    const float ez[3] = {0.0f, 0.0f, 1.0f};
    float zu[3];
    sbt::cross_fma(ez, up_w, zu);
    const float lean_cur = atan2f(sbt::dot3_fma(zu, fwd_w), up_w[2]);
    const float lean_rate = sbt::dot3_fma(c.ang, fwd_w);
    const float s = (lean_target - lean_cur) * lean_spring - lean_rate * lean_damping;
    float tau[3], t[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) tau[k] = fwd_w[k] * s * mass * 0.1f;
    sbt::mv_fma(c.iw, tau, t);
    const bool on = is_bike && active;
#pragma unroll
    for (int k = 0; k < 3; ++k) terms[kLean][k] = on ? t[k] * dt : 0.0f;
  }
  {
    float pr[3], prop[3], td[3];
    sbt::rotate_vec(c.q, po, pr);
#pragma unroll
    for (int k = 0; k < 3; ++k) prop[k] = c.pos[k] + pr[k];
    const bool submerged_prop = prop[2] <= water_z;
    const float lat = right_in * thrust_lat;
#pragma unroll
    for (int k = 0; k < 3; ++k) td[k] = fwd_w[k] - up_w[k] * 0.2f - right_w[k] * lat;
    const float tn = fmaxf(sqrtf(sbt::dot3_fma(td, td)), 1e-6f);
    const float thrust = thrust_force * fwd_in;
    const float rudder = -right_in * sbt::dot3_fma(c.lin, fwd_w) * rudder_factor;
    float ft[3], fr[3], dv_b[3], dw_b[3], ra[3], rb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ft[k] = td[k] / tn * thrust;
      fr[k] = right_w[k] * rudder;
    }
    force_at(c, ft, prop, dv_b, dw_b);
    force_at(c, fr, prop, ra, rb);
    const bool on = vt == kBoat && active && submerged_prop;
    const bool thrusting = on && fabsf(fwd_in) > 0.0f;
    // The reference adds this zero term too; kept so NaN and inf propagate alike.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      terms[kBoatZero][k] = (thrusting ? dv_b[k] - 0.0f * dv_b[k] : 0.0f) * 0.0f;
      terms[kBoatDv][k] = on ? dv_b[k] + ra[k] : 0.0f;
      terms[kBoatDw][k] = on ? dw_b[k] + rb[k] : 0.0f;
    }
  }
}

// Warp 2, lane 0: the hovercar (its dw before the keep-upright term, which
// the fold adds) and its unflip window, then the boat's water drag; both
// read the velocity's direction.
__device__ void hover_and_drag(const VehicleArgs& a, int v, const Chassis& c, int vt,
                               bool active, float fwd_in, float right_in, float water_z,
                               const float fwd_w[3], const float right_w[3],
                               const float up_w[3], float (*terms)[3]) {
  const float areas[3] = {in<float>(a, kAreas)[v * 3 + 0], in<float>(a, kAreas)[v * 3 + 1],
                          in<float>(a, kAreas)[v * 3 + 2]};
  const float unflip = in<float>(a, kUnflip)[v];
  const float up_in = in<float>(a, kInUp)[v];
  const float dt = c.dt, mass = c.mass;
  const float v_mag = sqrtf(sbt::dot3_fma(c.lin, c.lin));
  const float vd = fmaxf(v_mag, 1e-6f);
  const float nv[3] = {c.lin[0] / vd, c.lin[1] / vd, c.lin[2] / vd};
  const float pf = fabsf(sbt::dot3_fma(nv, fwd_w)), ps = fabsf(sbt::dot3_fma(nv, right_w)),
              pu = fabsf(sbt::dot3_fma(nv, up_w));
  {
    const float proj = pf * areas[0] * 0.1f + ps * areas[1] * 0.5f + pu * areas[2] * 0.75f;
    const float f_d = 510.0f * v_mag * v_mag * proj;
    float drag[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) drag[k] = -nv[k] * f_d * c.dt_m;
    if (sqrtf(sbt::dot3_fma(drag, drag)) > v_mag) {
#pragma unroll
      for (int k = 0; k < 3; ++k) drag[k] = -c.lin[k];
    }
    const bool on = vt == kBoat && c.pos[2] < water_z + 1.0f && v_mag > 1e-3f;
#pragma unroll
    for (int k = 0; k < 3; ++k) terms[kDrag][k] = on ? drag[k] : 0.0f;
  }
  const float cos_theta = up_w[2];
  const float up_factor = 1.0f / fmaxf(cos_theta, 0.7f);
  const float hover = (1.0f + up_in * 0.6f) * up_factor * mass * 9.81f;
  const float fwd_f = mass * 10.0f * fwd_in;
  const float fz = fwd_w[2] * fwd_f;
  const float pitch = mass * -0.5f * fwd_in, yaw = mass * -3.0f * right_in,
              roll = mass * 2.0f * right_in;
  float dv_h[3], tau[3], dw_h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float hf = cos_theta > 0.0f ? up_w[k] * hover : 0.0f;
    dv_h[k] = (hf + fwd_w[k] * fwd_f + up_w[k] * -fz) * c.dt_m;
    tau[k] = right_w[k] * pitch + up_w[k] * yaw + fwd_w[k] * roll;
  }
  sbt::mv_fma(c.iw, tau, dw_h);
  const float nu = unflip > 0.0f ? (cos_theta > 0.2f ? -1.0f : unflip - dt)
                                 : (cos_theta < -0.9f ? 1.0f : unflip);
  const bool lift = unflip > 0.0f && cos_theta <= 0.2f;
  dv_h[2] = dv_h[2] + (lift ? 9.81f * dt : 0.0f);
  const float proj_a = pf * 2.0f * 0.2f + ps * 4.0f * 0.5f + pu * 8.0f * 0.75f;
  const float f_ad = 0.6465f * v_mag * v_mag * proj_a;
#pragma unroll
  for (int k = 0; k < 3; ++k) dv_h[k] = dv_h[k] + (v_mag > 1e-3f ? -nv[k] * f_ad * c.dt_m : 0.0f);
  const bool on = vt == kHover && active;
#pragma unroll
  for (int k = 0; k < 3; ++k) terms[kHoverDv][k] = on ? dv_h[k] : 0.0f;
  put(terms, kHoverDw, dw_h);
  a.out[kOUnflip * a.V + v] = on ? nu : unflip;
}

__global__ void __launch_bounds__(kWarps * 32) vehicle_forces_kernel(const VehicleArgs a) {
  __shared__ float terms[kTerms][3];
  const int v = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The chassis and the common fields: broadcast loads, issued together.
  Chassis c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.pos[k] = in<float>(a, kPos)[v * 3 + k];
    c.lin[k] = in<float>(a, kLin)[v * 3 + k];
    c.ang[k] = in<float>(a, kAng)[v * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c.q[k] = in<float>(a, kQuat)[v * 4 + k];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) c.iw[r][s] = in<float>(a, kIw)[v * 9 + r * 3 + s];
  c.mass = in<float>(a, kMass)[v];
  const float yq[4] = {in<float>(a, kYq)[v * 4 + 0], in<float>(a, kYq)[v * 4 + 1],
                       in<float>(a, kYq)[v * 4 + 2], in<float>(a, kYq)[v * 4 + 3]};
  const int vt = in<int>(a, kVtype)[v];
  const bool active = in<bool>(a, kActive)[v];
  const float fwd_in = in<float>(a, kInFwd)[v], right_in = in<float>(a, kInRight)[v];
  const float water_z = *in<float>(a, kWaterZ);
  const bool righting_on = in<bool>(a, kRighting)[v];
  c.dt = a.dt;
  c.dt_m = a.dt / c.mass;

  if (warp == 1) {
    if (lane == 0) {
      float dw_r[3];
      righting(c, yq, dw_r);
      put(terms, kRightDw, dw_r);
    }
  } else {
    // Frame vectors, model space -> world through the y-forward convention.
    const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
    const float inv_yq[4] = {-yq[0], -yq[1], -yq[2], yq[3]};
    float fwd_os[3], right_os[3], up_os[3], fwd_w[3], right_w[3], up_w[3];
    sbt::rotate_vec(inv_yq, ey, fwd_os);
    sbt::rotate_vec(inv_yq, ex, right_os);
    sbt::cross_fma(right_os, fwd_os, up_os);
    sbt::rotate_vec(c.q, fwd_os, fwd_w);
    sbt::rotate_vec(c.q, right_os, right_w);
    sbt::rotate_vec(c.q, up_os, up_w);
    if (warp == 0) {
      wheels(a, v, lane, c, vt, active, fwd_in, right_in, fwd_w, right_w, up_w, terms);
    } else if (lane == 0) {
      if (warp == 2)
        hover_and_drag(a, v, c, vt, active, fwd_in, right_in, water_z, fwd_w, right_w, up_w,
                       terms);
      else
        lean_and_boat(a, v, c, vt, active, fwd_in, right_in, water_z, fwd_w, right_w, up_w,
                      terms);
    }
  }
  __syncthreads();
  if (warp != 0 || lane >= 3) return;
  // Lane k folds component k of dv and dw in the reference's order.
  const int k = lane;
  const bool is_wheeled = vt == kCar || vt == kBike;
  const bool hover_on = vt == kHover && active;
  float dv_wh = 0.0f, dw_wh = 0.0f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    dv_wh = dv_wh + terms[kWheelDv0 + w][k];
    dw_wh = dw_wh + terms[kWheelDw0 + w][k];
  }
  float dv = 0.0f + (is_wheeled ? dv_wh : 0.0f);
  float dw = 0.0f + (is_wheeled ? dw_wh : 0.0f);
  dw = dw + terms[kLean][k];
  dv = dv + terms[kBoatZero][k];
  dv = dv + terms[kBoatDv][k];
  dw = dw + terms[kBoatDw][k];
  dv = dv + terms[kDrag][k];
  const float dw_r = terms[kRightDw][k];
  const float dw_h = terms[kHoverDw][k] * c.dt + dw_r;
  dv = dv + terms[kHoverDv][k];
  dw = dw + (hover_on ? dw_h : 0.0f);
  dw = dw + ((righting_on && is_wheeled) ? dw_r : 0.0f);
  const bool gate = active || vt == kHover || is_wheeled;
  a.out[kODv * a.V + v * 3 + k] = gate ? dv : 0.0f;
  a.out[kODw * a.V + v * 3 + k] = gate ? dw : 0.0f;
}

}  // namespace

// The wrapper's arguments in one host buffer of 8-byte slots
// (kernels/vehicles.py:_PACK): the 48 input pointers (VehicleArgs::in),
// the output buffer, V, dt as a double.
extern "C" int vehicle_forces(const long long* s, void* stream) {
  VehicleArgs a;
  for (int k = 0; k < kNumIn; ++k) a.in[k] = reinterpret_cast<const void*>(s[k]);
  a.out = reinterpret_cast<float*>(s[kNumIn]);
  a.V = static_cast<int>(s[kNumIn + 1]);
  double dt;
  memcpy(&dt, &s[kNumIn + 2], sizeof(double));
  a.dt = static_cast<float>(dt);
  if (a.V < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.V > 0) {
    vehicle_forces_kernel<<<a.V, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
