// Head-to-head driver for the REFERENCE estimator (OpenVINS/UVIO, built
// out-of-repo from /root/reference with the shim headers in ./shims).
//
// Mirrors ov_msckf/src/run_simulation.cpp's ROS-free loop (same gt init,
// same one-frame camera buffering) and additionally DUMPS the exact
// measurement streams so uvio_jax can be replayed on identical inputs:
//
//   <out>/imu.csv    t wx wy wz ax ay az
//   <out>/cam.csv    t camid featid u v          (raw distorted pixels)
//   <out>/init.txt   t qx qy qz qw px py pz vx vy vz bgx.. bax..
//   <out>/ref_est.txt  TUM: t px py pz qx qy qz qw   (reference estimate)
//   <out>/gt.txt       TUM: same times, simulator groundtruth
//
// Usage: ref_head2head <estimator_config.yaml> <out_dir> [max_seconds]
#include <cstdio>
#include <fstream>
#include <memory>
#include <string>

#include "core/VioManager.h"
#include "core/VioManagerOptions.h"
#include "sim/Simulator.h"
#include "state/State.h"
#include "utils/opencv_yaml_parse.h"
#include "utils/print.h"
#include "utils/sensor_data.h"

using namespace ov_msckf;

int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <config.yaml> <out_dir> [max_seconds]\n", argv[0]);
    return 1;
  }
  std::string config_path = argv[1];
  std::string out = argv[2];
  double max_seconds = (argc > 3) ? std::stod(argv[3]) : 1e9;

  auto parser = std::make_shared<ov_core::YamlParser>(config_path);
  std::string verbosity = "WARNING";
  parser->parse_config("verbosity", verbosity);
  ov_core::Printer::setPrintLevel(verbosity);

  VioManagerOptions params;
  params.print_and_load(parser);
  params.print_and_load_simulation(parser);
  params.num_opencv_threads = 0; // repeatability
  params.use_multi_threading_pubs = false;
  params.use_multi_threading_subs = false;
  auto sim = std::make_shared<Simulator>(params);
  auto sys = std::make_shared<VioManager>(params);
  if (!parser->successful()) {
    std::fprintf(stderr, "config parse failure\n");
    return 1;
  }

  // Dump the estimator's STARTING calibration (perturbed by the
  // Simulator ctor when sim_do_perturbation is set — params is taken by
  // reference, run_simulation.cpp:97) so the replay seeds identically:
  //   dt
  //   per cam: intr(8) q_ItoC(xyzw) p_IinC(3)
  {
    std::ofstream f(out + "/calib_seed.txt");
    f.precision(17);
    f << params.calib_camimu_dt << "\n";
    for (int i = 0; i < params.state_options.num_cameras; i++) {
      Eigen::VectorXd intr = params.camera_intrinsics.at(i)->get_value();
      Eigen::VectorXd ext = params.camera_extrinsics.at(i); // [q_ItoC; p_IinC]
      for (int r = 0; r < 8; r++)
        f << intr(r) << " ";
      for (int r = 0; r < 7; r++)
        f << ext(r) << (r + 1 < 7 ? " " : "\n");
    }
  }

  // groundtruth initialization at the first IMU time (run_simulation.cpp:115-131)
  double next_imu_time = sim->current_timestamp() + 1.0 / params.sim_freq_imu;
  Eigen::Matrix<double, 17, 1> imustate;
  if (!sim->get_state(next_imu_time, imustate)) {
    std::fprintf(stderr, "simulator could not produce the initial state\n");
    return 1;
  }
  imustate(0, 0) -= sim->get_true_parameters().calib_camimu_dt;
  sys->initialize_with_gt(imustate);

  std::ofstream f_imu(out + "/imu.csv"), f_cam(out + "/cam.csv");
  std::ofstream f_init(out + "/init.txt"), f_est(out + "/ref_est.txt"), f_gt(out + "/gt.txt");
  f_imu.precision(17);
  f_cam.precision(17);
  f_init.precision(17);
  f_est.precision(17);
  f_gt.precision(17);
  for (int i = 0; i < 17; i++)
    f_init << imustate(i, 0) << (i + 1 < 17 ? " " : "\n");

  double t_start = -1, t_wall0 = 0;
  int n_frames = 0;
  auto clk0 = std::chrono::steady_clock::now();
  (void)t_wall0;

  double buffer_timecam = -1;
  std::vector<int> buffer_camids;
  std::vector<std::vector<std::pair<size_t, Eigen::VectorXf>>> buffer_feats;

  while (sim->ok()) {
    ov_core::ImuData m;
    if (sim->get_next_imu(m.timestamp, m.wm, m.am)) {
      if (t_start < 0)
        t_start = m.timestamp;
      if (m.timestamp - t_start > max_seconds)
        break;
      sys->feed_measurement_imu(m);
      f_imu << m.timestamp << "," << m.wm(0) << "," << m.wm(1) << "," << m.wm(2) << ","
            << m.am(0) << "," << m.am(1) << "," << m.am(2) << "\n";
    }
    double time_cam;
    std::vector<int> camids;
    std::vector<std::vector<std::pair<size_t, Eigen::VectorXf>>> feats;
    if (sim->get_next_cam(time_cam, camids, feats)) {
      if (buffer_timecam != -1) {
        sys->feed_measurement_simulation(buffer_timecam, buffer_camids, buffer_feats);
        n_frames++;
        // record estimate (camera-clock state time) + matching groundtruth
        auto state = sys->get_state();
        Eigen::Vector4d q = state->_imu->quat(); // JPL q_GtoI
        Eigen::Vector3d p = state->_imu->pos();
        f_est << state->_timestamp << " " << p(0) << " " << p(1) << " " << p(2) << " "
              << q(0) << " " << q(1) << " " << q(2) << " " << q(3) << "\n";
        Eigen::Matrix<double, 17, 1> gts;
        if (sim->get_state(buffer_timecam + sim->get_true_parameters().calib_camimu_dt, gts)) {
          f_gt << state->_timestamp << " " << gts(5) << " " << gts(6) << " " << gts(7) << " "
               << gts(1) << " " << gts(2) << " " << gts(3) << " " << gts(4) << "\n";
        }
      }
      buffer_timecam = time_cam;
      buffer_camids = camids;
      buffer_feats = feats;
      for (size_t c = 0; c < camids.size(); c++)
        for (auto &pr : feats[c])
          f_cam << time_cam << "," << camids[c] << "," << pr.first << ","
                << pr.second(0) << "," << pr.second(1) << "\n";
    }
  }
  auto clk1 = std::chrono::steady_clock::now();
  // final converged calibration (same row format as calib_seed.txt) for
  // the online-calibration head-to-head
  {
    auto state = sys->get_state();
    std::ofstream f(out + "/ref_calib_final.txt");
    f.precision(17);
    f << state->_calib_dt_CAMtoIMU->value()(0) << "\n";
    for (int i = 0; i < params.state_options.num_cameras; i++) {
      Eigen::VectorXd intr = state->_cam_intrinsics.at(i)->value();
      Eigen::Vector4d q = state->_calib_IMUtoCAM.at(i)->quat();
      Eigen::Vector3d p = state->_calib_IMUtoCAM.at(i)->pos();
      for (int r = 0; r < 8; r++)
        f << intr(r) << " ";
      for (int r = 0; r < 4; r++)
        f << q(r) << " ";
      for (int r = 0; r < 3; r++)
        f << p(r) << (r + 1 < 3 ? " " : "\n");
    }
  }
  double wall = std::chrono::duration<double>(clk1 - clk0).count();
  std::printf("{\"frames\": %d, \"wall_s\": %.3f, \"fps\": %.1f}\n", n_frames, wall,
              n_frames / wall);
  return 0;
}
