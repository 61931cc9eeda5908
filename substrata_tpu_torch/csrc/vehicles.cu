// KJ: the vehicle force models (car, bike, boat, hovercar), one thread per
// vehicle.
//
// Replaces substrata_tpu/physics/vehicles/manager.py:_vehicle_update_one
// (:298-594), the body of the vmap at :637-649; plain twin:
// substrata_tpu_torch/kernels/vehicles.py:vehicle_forces_plain.  The thread
// reads its chassis state, its wheel-ray hits (kernel KH) and its vehicle
// row, and writes the chassis velocity deltas and the new controller state
// (steering, suspension length, wheel spin and rotation, unflip time,
// contact, gear, shift timer, rpm).  jnp.interp and the one-hot gear select
// become short table walks.  What bounds it on the card: latency — 8
// vehicles are 8 threads of ~3,000 dependent float operations (four wheels,
// two keep-upright controllers with their transcendentals); the bytes
// (~700 per vehicle) and the operations are far below a microsecond of the
// card's rates.  The design is one pass with every intermediate in
// registers and each output written once.
#include "common.cuh"

namespace {

constexpr int kCar = 0, kBike = 1, kBoat = 2, kHover = 3;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kRpmPerRadS = 9.549296585513721f;    // 60 / (2 pi)
constexpr float kDeg = 57.29577951308232f;            // 180 / pi
__constant__ float kBikeGears[6] = {2.27f, 1.63f, 1.30f, 1.09f, 0.96f, 0.88f};
__constant__ float kCarGears[6] = {2.66f, 1.78f, 1.30f, 1.0f, 0.74f, 0.74f};

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

// kernels/vehicles.py:righting_torque_dv
__device__ void righting(const float q[4], const float ang[3], float mass, const float iw[3][3],
                         const float yq[4], float dt, float out[3]) {
  const float ex[3] = {1.0f, 0.0f, 0.0f};
  const float yqc[4] = {-yq[0], -yq[1], -yq[2], yq[3]};
  float r_os[3], r_ws[3];
  sbt::rotate_vec(yqc, ex, r_os);
  sbt::rotate_vec(q, r_os, r_ws);
  const float yaw = atan2f(r_ws[1], r_ws[0]);
  const float half = 0.5f * yaw;
  const float s = sinf(half);
  const float aq[4] = {0.0f * s, 0.0f * s, 1.0f * s, cosf(half)};
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  float desired[4], cur[4];
  qmul(aq, yq, desired);
  qmul(desired, qc, cur);
  if (cur[3] < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = -cur[k];
  }
  const float v3[3] = {cur[0], cur[1], cur[2]};
  const float sin_half = sqrtf(sbt::dot3(v3, v3));
  const float angle = 2.0f * atan2f(sin_half, cur[3]);
  const float safe = fmaxf(sin_half, 1e-12f);
  float torque[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float axis = sin_half < 1e-8f ? ex[k] : cur[k] / safe;
    torque[k] = (axis * angle * 3.0f - ang[k]) * mass * 1.5f;
  }
  sbt::mv(iw, torque, out);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = out[k] * dt;
}

struct Chassis {
  float pos[3], q[4], lin[3], ang[3], mass, iw[3][3], dt, dt_m;
};

// (dv, dw) of one force at a world point (manager.py:add_force_at).
__device__ void force_at(const Chassis& c, const float f[3], const float point[3], float dv[3],
                         float dw[3]) {
  const float r[3] = {point[0] - c.pos[0], point[1] - c.pos[1], point[2] - c.pos[2]};
  float tau[3];
  sbt::cross3(r, f, tau);
  sbt::mv(c.iw, tau, dw);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dv[k] = f[k] * c.dt_m;
    dw[k] = dw[k] * c.dt;
  }
}

__global__ void vehicle_forces_kernel(
    const int* __restrict__ vtype, const bool* __restrict__ active_, const float* __restrict__ y_fwd_quat,
    const float* __restrict__ wheel_attach, const float* __restrict__ wheel_radius,
    const int* __restrict__ n_wheels, const float* __restrict__ sus_min,
    const float* __restrict__ sus_max, const float* __restrict__ spring_freq,
    const float* __restrict__ spring_damping, const float* __restrict__ max_steer,
    const float* __restrict__ engine_torque, const float* __restrict__ engine_max_rpm,
    const float* __restrict__ brake_torque, const float* __restrict__ handbrake_torque,
    const float* __restrict__ mu_long, const float* __restrict__ mu_lat_,
    const float* __restrict__ steer_relax, const float* __restrict__ lean_spring,
    const float* __restrict__ lean_damping, const float* __restrict__ thrust_force,
    const float* __restrict__ propellor_os, const float* __restrict__ rudder_factor,
    const float* __restrict__ thrust_lateral, const float* __restrict__ areas,
    const float* __restrict__ steering, const float* __restrict__ prev_sus_len,
    const float* __restrict__ wheel_omega, const float* __restrict__ wheel_rot,
    const float* __restrict__ unflip_time, const bool* __restrict__ righting_active,
    const int* __restrict__ gear_, const float* __restrict__ shift_timer,
    const float* __restrict__ in_fwd, const float* __restrict__ in_right,
    const float* __restrict__ in_up, const bool* __restrict__ in_brake,
    const bool* __restrict__ in_handbrake, const float* __restrict__ body_pos,
    const float* __restrict__ body_quat, const float* __restrict__ body_lin,
    const float* __restrict__ body_ang, const float* __restrict__ mass_,
    const float* __restrict__ iw_, const float* __restrict__ hit_t,
    const float* __restrict__ hit_n, const bool* __restrict__ hit_ok,
    const float* __restrict__ water_z_, int V, float dt, float* __restrict__ o_dv,
    float* __restrict__ o_dw, float* __restrict__ o_steering, float* __restrict__ o_sus_len,
    float* __restrict__ o_omega, float* __restrict__ o_rot, float* __restrict__ o_unflip,
    bool* __restrict__ o_contact, int* __restrict__ o_gear, float* __restrict__ o_shift_timer,
    float* __restrict__ o_rpm) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  Chassis c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.pos[k] = body_pos[v * 3 + k];
    c.lin[k] = body_lin[v * 3 + k];
    c.ang[k] = body_ang[v * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c.q[k] = body_quat[v * 4 + k];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) c.iw[a][b] = iw_[v * 9 + a * 3 + b];
  c.mass = mass_[v];
  c.dt = dt;
  c.dt_m = dt / c.mass;
  const float mass = c.mass;
  const int vt = vtype[v];
  const bool active = active_[v];
  const float fwd_in = in_fwd[v], right_in = in_right[v], up_in = in_up[v];
  const float water_z = *water_z_;
  const float yq[4] = {y_fwd_quat[v * 4 + 0], y_fwd_quat[v * 4 + 1], y_fwd_quat[v * 4 + 2],
                       y_fwd_quat[v * 4 + 3]};
  const float rad = wheel_radius[v];

  // Frame vectors, model space -> world through the y-forward convention.
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  const float inv_yq[4] = {-yq[0], -yq[1], -yq[2], yq[3]};
  float fwd_os[3], right_os[3], up_os[3], fwd_w[3], right_w[3], up_w[3];
  sbt::rotate_vec(inv_yq, ey, fwd_os);
  sbt::rotate_vec(inv_yq, ex, right_os);
  sbt::cross3(right_os, fwd_os, up_os);
  sbt::rotate_vec(c.q, fwd_os, fwd_w);
  sbt::rotate_vec(c.q, right_os, right_w);
  sbt::rotate_vec(c.q, up_os, up_w);

  const bool is_wheeled = vt == kCar || vt == kBike;
  const bool is_bike = vt == kBike;

  // Steering smoothing.
  const float target = -right_in * max_steer[v];
  const float relax = steer_relax[v];
  const float step = fminf(fmaxf(target - steering[v], -relax * dt), relax * dt);
  const float new_steering = (is_wheeled && active) ? steering[v] + step : 0.0f;

  // Drivetrain state shared by the wheels.
  const float speed_fwd = sbt::dot3(c.lin, fwd_w);
  const float omega_avg = fabsf(speed_fwd) / rad;
  const bool in_reverse = fwd_in < -0.01f && speed_fwd < 0.5f;
  const bool brake_from_input = fwd_in < -0.01f && speed_fwd >= 0.5f;
  const int gear = gear_[v];
  const int max_gear = is_bike ? 5 : 4;
  const float shift_up_rpm = is_bike ? 9000.0f : 4000.0f;
  const float shift_down_rpm = is_bike ? 5000.0f : 2000.0f;
  const float switch_time = is_bike ? 0.2f : 0.5f;
  const float ratio_fwd = (gear >= 0 && gear < 6) ? (is_bike ? kBikeGears[gear] : kCarGears[gear]) : 0.0f;
  const float ratio = (in_reverse ? -2.90f : ratio_fwd) * 3.42f;
  const float rpm_raw = fabsf(omega_avg) * fabsf(ratio) * kRpmPerRadS;
  const float max_rpm = engine_max_rpm[v];
  const float new_rpm = fminf(fmaxf(rpm_raw, 1000.0f), max_rpm);
  const float timer = shift_timer[v];
  const bool can_shift = timer <= 0.0f;
  const bool shift_up = can_shift && !in_reverse && rpm_raw > shift_up_rpm && gear < max_gear;
  const bool shift_down = can_shift && !in_reverse && rpm_raw < shift_down_rpm && gear > 0;
  int new_gear = gear + (shift_up ? 1 : 0) - (shift_down ? 1 : 0);
  float new_timer = (shift_up || shift_down) ? switch_time : fmaxf(timer - dt, 0.0f);
  const bool clutch = timer <= 0.0f;
  const float throttle = fabsf(fwd_in);
  float t_norm = interp3(new_rpm / fmaxf(max_rpm, 1.0f), 0.0f, 0.66f, 1.0f, 0.8f, 1.0f, 0.8f);
  if (rpm_raw >= max_rpm) t_norm = 0.0f;
  const float t_engine = engine_torque[v] * t_norm * throttle;
  const float t_wheel = t_engine * ratio * (is_bike ? 1.0f : 0.5f);
  const bool driving = clutch && !brake_from_input && throttle > 0.01f;
  const bool braking = in_brake[v] || brake_from_input;
  const bool coasting = fabsf(fwd_in) < 0.01f && clutch;
  const float engine_omega = new_rpm / kRpmPerRadS;

  const int nw = n_wheels[v];
  const float m_quarter = mass / fmaxf(static_cast<float>(nw), 1.0f);
  const float sp = kTwoPi * spring_freq[v];
  const float k_spring = m_quarter * (sp * sp);
  const float c_damp = spring_damping[v] * 2.0f * sqrtf(k_spring * m_quarter);
  const float smin = sus_min[v], smax = sus_max[v];
  const float ray_len = smax + rad;
  const float mu_pk = is_bike ? 8.0f : 1.2f * mu_long[v];
  const float mu_sl = is_bike ? 3.0f : 1.0f * mu_long[v];
  const float ml = mu_lat_[v];
  const float mu0 = is_bike ? 0.0f : 0.0f * ml;
  const float mu1 = is_bike ? 3.6f : 1.2f * ml;
  const float mu2 = is_bike ? 2.0f : 1.0f * ml;
  const float ca = cosf(new_steering), sa = sinf(new_steering);
  const float omega_cap = (max_rpm / kRpmPerRadS) / fmaxf(fabsf(ratio), 0.1f);

  float dv_wh[3] = {0.0f, 0.0f, 0.0f}, dw_wh[3] = {0.0f, 0.0f, 0.0f};
  for (int w = 0; w < 4; ++w) {
    const int r4 = v * 4 + w;
    const float ht = hit_t[r4];
    const float n[3] = {hit_n[r4 * 3 + 0], hit_n[r4 * 3 + 1], hit_n[r4 * 3 + 2]};
    const float wa[3] = {wheel_attach[r4 * 3 + 0], wheel_attach[r4 * 3 + 1],
                         wheel_attach[r4 * 3 + 2]};
    float att[3];
    sbt::rotate_vec(c.q, wa, att);
    const bool hit = hit_ok[r4] && w < nw && ht <= ray_len;
    const float sus_len = fminf(fmaxf(ht - rad, smin), smax);
    const float compression = smax - sus_len;
    const float comp_rate = (prev_sus_len[r4] - sus_len) / dt;
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
    const float dn = sbt::dot3(wf, n);
    float wfl[3], wlat[3], vc[3], v_cp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) wfl[k] = wf[k] - n[k] * dn;
    const float wn = fmaxf(sqrtf(sbt::dot3(wfl, wfl)), 1e-6f);
#pragma unroll
    for (int k = 0; k < 3; ++k) wfl[k] = wfl[k] / wn;
    sbt::cross3(n, wfl, wlat);
    sbt::cross3(c.ang, rel, vc);
#pragma unroll
    for (int k = 0; k < 3; ++k) v_cp[k] = c.lin[k] + vc[k];
    const float v_long = sbt::dot3(v_cp, wfl);
    const float v_lat = sbt::dot3(v_cp, wlat);

    const bool driven = is_bike ? w == 1 : w < 2;
    const float f_drive = (driven && hit && driving) ? t_wheel / rad : 0.0f;
    const float f_eng = (driven && coasting) ? 0.1f * engine_omega * fabsf(ratio) / rad : 0.0f;
    float f_cap = ((in_handbrake[v] && w >= 2) ? handbrake_torque[v]
                                                : (braking ? brake_torque[v] : 0.0f)) / rad;
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

    float force[3], a[3], b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float fk = -up_w[k] * -f_spring + wfl[k] * f_long + wlat[k] * f_lat;
      force[k] = hit ? fk : 0.0f;
    }
    force_at(c, force, contact, a, b);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dv_wh[k] = dv_wh[k] + a[k];
      dw_wh[k] = dw_wh[k] + b[k];
    }

    // Wheel spin, contact and suspension state.
    const float excess = fmaxf(fabsf(f_long_want) - f_slide, 0.0f) * rad;
    float spin = wheel_omega[r4] + signf_(f_long_want) * excess / 0.9f * dt;
    spin = fminf(fmaxf(spin, -omega_cap), omega_cap);
    const float omega = (hit && spinning && driven) ? spin
                        : (hit ? v_long / rad : wheel_omega[r4] * 0.95f);
    o_omega[r4] = omega;
    o_rot[r4] = wheel_rot[r4] + omega * dt;
    o_sus_len[r4] = sus_len;
    o_contact[r4] = hit;
  }
  float dv[3], dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dv[k] = 0.0f + (is_wheeled ? dv_wh[k] : 0.0f);
    dw[k] = 0.0f + (is_wheeled ? dw_wh[k] : 0.0f);
  }

  // Bike lean controller: PD toward the centripetal-balance lean angle.
  {
    const float wheelbase = fmaxf(fabsf(wheel_attach[v * 12 + 1] - wheel_attach[v * 12 + 4]), 0.5f);
    const float yaw_rate = speed_fwd * tanf(new_steering) / wheelbase;
    const float lean_target = fminf(fmaxf(atan2f(speed_fwd * yaw_rate, 9.81f), -0.9f), 0.9f);
    const float ez[3] = {0.0f, 0.0f, 1.0f};
    float zu[3];
    sbt::cross3(ez, up_w, zu);
    const float lean_cur = atan2f(sbt::dot3(zu, fwd_w), up_w[2]);
    const float lean_rate = sbt::dot3(c.ang, fwd_w);
    const float s = (lean_target - lean_cur) * lean_spring[v] - lean_rate * lean_damping[v];
    float tau[3], t[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) tau[k] = fwd_w[k] * s * mass * 0.1f;
    sbt::mv(c.iw, tau, t);
    const bool on = is_bike && active;
#pragma unroll
    for (int k = 0; k < 3; ++k) dw[k] = dw[k] + (on ? t[k] * dt : 0.0f);
  }

  // Boat: thrust and rudder at the propeller while it is under water.
  {
    const float po[3] = {propellor_os[v * 3 + 0], propellor_os[v * 3 + 1], propellor_os[v * 3 + 2]};
    float pr[3], prop[3], td[3];
    sbt::rotate_vec(c.q, po, pr);
#pragma unroll
    for (int k = 0; k < 3; ++k) prop[k] = c.pos[k] + pr[k];
    const bool submerged_prop = prop[2] <= water_z;
    const float lat = right_in * thrust_lateral[v];
#pragma unroll
    for (int k = 0; k < 3; ++k) td[k] = fwd_w[k] - up_w[k] * 0.2f - right_w[k] * lat;
    const float tn = fmaxf(sqrtf(sbt::dot3(td, td)), 1e-6f);
    const float thrust = thrust_force[v] * fwd_in;
    const float rudder = -right_in * sbt::dot3(c.lin, fwd_w) * rudder_factor[v];
    float ft[3], fr[3], dv_b[3], dw_b[3], a[3], b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ft[k] = td[k] / tn * thrust;
      fr[k] = right_w[k] * rudder;
    }
    force_at(c, ft, prop, dv_b, dw_b);
    force_at(c, fr, prop, a, b);
    const bool on = vt == kBoat && active && submerged_prop;
    const bool thrusting = on && fabsf(fwd_in) > 0.0f;
    // The reference adds this zero term too; kept so NaN and inf propagate alike.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dv[k] = dv[k] + (thrusting ? dv_b[k] - 0.0f * dv_b[k] : 0.0f) * 0.0f;
      dv[k] = dv[k] + (on ? dv_b[k] + a[k] : 0.0f);
      dw[k] = dw[k] + (on ? dw_b[k] + b[k] : 0.0f);
    }
  }

  // Boat water drag and hovercar air drag share the velocity direction.
  const float v_mag = sqrtf(sbt::dot3(c.lin, c.lin));
  const float vd = fmaxf(v_mag, 1e-6f);
  const float nv[3] = {c.lin[0] / vd, c.lin[1] / vd, c.lin[2] / vd};
  const float pf = fabsf(sbt::dot3(nv, fwd_w)), ps = fabsf(sbt::dot3(nv, right_w)),
              pu = fabsf(sbt::dot3(nv, up_w));
  {
    const float proj = pf * areas[v * 3 + 0] * 0.1f + ps * areas[v * 3 + 1] * 0.5f +
                       pu * areas[v * 3 + 2] * 0.75f;
    const float f_d = 510.0f * v_mag * v_mag * proj;
    float drag[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) drag[k] = -nv[k] * f_d * c.dt_m;
    if (sqrtf(sbt::dot3(drag, drag)) > v_mag) {
#pragma unroll
      for (int k = 0; k < 3; ++k) drag[k] = -c.lin[k];
    }
    const bool on = vt == kBoat && c.pos[2] < water_z + 1.0f && v_mag > 1e-3f;
#pragma unroll
    for (int k = 0; k < 3; ++k) dv[k] = dv[k] + (on ? drag[k] : 0.0f);
  }

  // Hovercar.
  const float unflip = unflip_time[v];
  float new_unflip = unflip;
  {
    const float cos_theta = up_w[2];
    const float up_factor = 1.0f / fmaxf(cos_theta, 0.7f);
    const float hover = (1.0f + up_in * 0.6f) * up_factor * mass * 9.81f;
    const float fwd_f = mass * 10.0f * fwd_in;
    const float fz = fwd_w[2] * fwd_f;
    const float pitch = mass * -0.5f * fwd_in, yaw = mass * -3.0f * right_in,
                roll = mass * 2.0f * right_in;
    float dv_h[3], tau[3], dw_h[3], dw_r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float hf = cos_theta > 0.0f ? up_w[k] * hover : 0.0f;
      dv_h[k] = (hf + fwd_w[k] * fwd_f + up_w[k] * -fz) * c.dt_m;
      tau[k] = right_w[k] * pitch + up_w[k] * yaw + fwd_w[k] * roll;
    }
    sbt::mv(c.iw, tau, dw_h);
    righting(c.q, c.ang, mass, c.iw, yq, dt, dw_r);
#pragma unroll
    for (int k = 0; k < 3; ++k) dw_h[k] = dw_h[k] * dt + dw_r[k];
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
    for (int k = 0; k < 3; ++k) {
      dv[k] = dv[k] + (on ? dv_h[k] : 0.0f);
      dw[k] = dw[k] + (on ? dw_h[k] : 0.0f);
    }
    if (on) new_unflip = nu;
  }

  // Righting (car, bike).
  {
    float dw_r[3];
    righting(c.q, c.ang, mass, c.iw, yq, dt, dw_r);
    const bool on = righting_active[v] && is_wheeled;
#pragma unroll
    for (int k = 0; k < 3; ++k) dw[k] = dw[k] + (on ? dw_r[k] : 0.0f);
  }

  const bool gate = active || vt == kHover || is_wheeled;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_dv[v * 3 + k] = gate ? dv[k] : 0.0f;
    o_dw[v * 3 + k] = gate ? dw[k] : 0.0f;
  }
  o_steering[v] = new_steering;
  o_unflip[v] = new_unflip;
  o_gear[v] = (is_wheeled && active) ? new_gear : gear;
  o_shift_timer[v] = is_wheeled ? new_timer : timer;
  o_rpm[v] = is_wheeled ? new_rpm : 0.0f;
}

}  // namespace

extern "C" int vehicle_forces(
    const int* vtype, const bool* active, const float* y_fwd_quat, const float* wheel_attach,
    const float* wheel_radius, const int* n_wheels, const float* sus_min, const float* sus_max,
    const float* spring_freq, const float* spring_damping, const float* max_steer,
    const float* engine_torque, const float* engine_max_rpm, const float* brake_torque,
    const float* handbrake_torque, const float* mu_long, const float* mu_lat,
    const float* steer_relax, const float* lean_spring, const float* lean_damping,
    const float* thrust_force, const float* propellor_os, const float* rudder_factor,
    const float* thrust_lateral, const float* areas, const float* steering,
    const float* prev_sus_len, const float* wheel_omega, const float* wheel_rot,
    const float* unflip_time, const bool* righting_active, const int* gear,
    const float* shift_timer, const float* in_fwd, const float* in_right, const float* in_up,
    const bool* in_brake, const bool* in_handbrake, const float* body_pos,
    const float* body_quat, const float* body_lin, const float* body_ang, const float* mass,
    const float* iw, const float* hit_t, const float* hit_n, const bool* hit_ok,
    const float* water_z, int V, float dt, float* o_dv, float* o_dw, float* o_steering,
    float* o_sus_len, float* o_omega, float* o_rot, float* o_unflip, bool* o_contact,
    int* o_gear, float* o_shift_timer, float* o_rpm, void* stream) {
  if (V > 0) {
    const int threads = 32;
    const int blocks = (V + threads - 1) / threads;
    vehicle_forces_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        vtype, active, y_fwd_quat, wheel_attach, wheel_radius, n_wheels, sus_min, sus_max,
        spring_freq, spring_damping, max_steer, engine_torque, engine_max_rpm, brake_torque,
        handbrake_torque, mu_long, mu_lat, steer_relax, lean_spring, lean_damping, thrust_force,
        propellor_os, rudder_factor, thrust_lateral, areas, steering, prev_sus_len, wheel_omega,
        wheel_rot, unflip_time, righting_active, gear, shift_timer, in_fwd, in_right, in_up,
        in_brake, in_handbrake, body_pos, body_quat, body_lin, body_ang, mass, iw, hit_t, hit_n,
        hit_ok, water_z, V, dt, o_dv, o_dw, o_steering, o_sus_len, o_omega, o_rot, o_unflip,
        o_contact, o_gear, o_shift_timer, o_rpm);
  }
  return static_cast<int>(cudaGetLastError());
}
