"""hilo_mpc_tpu — batched machine-learning-supported optimal control & estimation.

Flat public API mirroring the reference's namespace (reference:
hilo_mpc/__init__.py:43-101) so users of HILO-MPC find the same names; every
implementation underneath is JAX/XLA-native. See ARCHITECTURE.md.
"""
from .core.model import Model
from .core.series import OptimizationSeries, TimeSeries

__version__ = "0.8.3"

_LAZY = {
    # control
    "NMPC": ("hilo_mpc_tpu.control.nmpc", "NMPC"),
    "OptimalControlProblem": ("hilo_mpc_tpu.control.nmpc", "OptimalControlProblem"),
    "OCP": ("hilo_mpc_tpu.control.nmpc", "OptimalControlProblem"),
    "LMPC": ("hilo_mpc_tpu.control.lmpc", "LMPC"),
    "SMPC": ("hilo_mpc_tpu.control.smpc", "SMPC"),
    "LinearQuadraticRegulator": ("hilo_mpc_tpu.control.lqr", "LinearQuadraticRegulator"),
    "LQR": ("hilo_mpc_tpu.control.lqr", "LinearQuadraticRegulator"),
    "PID": ("hilo_mpc_tpu.control.pid", "PID"),
    # estimation
    "MovingHorizonEstimator": ("hilo_mpc_tpu.estimation.mhe", "MovingHorizonEstimator"),
    "MHE": ("hilo_mpc_tpu.estimation.mhe", "MovingHorizonEstimator"),
    "KalmanFilter": ("hilo_mpc_tpu.estimation.kf", "KalmanFilter"),
    "KF": ("hilo_mpc_tpu.estimation.kf", "KalmanFilter"),
    "ExtendedKalmanFilter": ("hilo_mpc_tpu.estimation.kf", "ExtendedKalmanFilter"),
    "EKF": ("hilo_mpc_tpu.estimation.kf", "ExtendedKalmanFilter"),
    "UnscentedKalmanFilter": ("hilo_mpc_tpu.estimation.kf", "UnscentedKalmanFilter"),
    "UKF": ("hilo_mpc_tpu.estimation.kf", "UnscentedKalmanFilter"),
    "ParticleFilter": ("hilo_mpc_tpu.estimation.pf", "ParticleFilter"),
    "PF": ("hilo_mpc_tpu.estimation.pf", "ParticleFilter"),
    # ml
    "ArtificialNeuralNetwork": ("hilo_mpc_tpu.ml.nn", "ArtificialNeuralNetwork"),
    "ANN": ("hilo_mpc_tpu.ml.nn", "ArtificialNeuralNetwork"),
    "Layer": ("hilo_mpc_tpu.ml.nn", "Layer"),
    "Dense": ("hilo_mpc_tpu.ml.nn", "Dense"),
    "Dropout": ("hilo_mpc_tpu.ml.nn", "Dropout"),
    "GaussianProcess": ("hilo_mpc_tpu.ml.gp.gp", "GaussianProcess"),
    "GP": ("hilo_mpc_tpu.ml.gp.gp", "GaussianProcess"),
    "GPArray": ("hilo_mpc_tpu.ml.gp.gp", "GPArray"),
    "Mean": ("hilo_mpc_tpu.ml.gp.means", "Mean"),
    "ZeroMean": ("hilo_mpc_tpu.ml.gp.means", "ZeroMean"),
    "OneMean": ("hilo_mpc_tpu.ml.gp.means", "OneMean"),
    "ConstantMean": ("hilo_mpc_tpu.ml.gp.means", "ConstantMean"),
    "LinearMean": ("hilo_mpc_tpu.ml.gp.means", "LinearMean"),
    "PolynomialMean": ("hilo_mpc_tpu.ml.gp.means", "PolynomialMean"),
    "Kernel": ("hilo_mpc_tpu.ml.gp.kernels", "Kernel"),
    "ConstantKernel": ("hilo_mpc_tpu.ml.gp.kernels", "ConstantKernel"),
    "SquaredExponentialKernel": ("hilo_mpc_tpu.ml.gp.kernels", "SquaredExponentialKernel"),
    "MaternKernel": ("hilo_mpc_tpu.ml.gp.kernels", "MaternKernel"),
    "Matern32Kernel": ("hilo_mpc_tpu.ml.gp.kernels", "Matern32Kernel"),
    "Matern52Kernel": ("hilo_mpc_tpu.ml.gp.kernels", "Matern52Kernel"),
    "ExponentialKernel": ("hilo_mpc_tpu.ml.gp.kernels", "ExponentialKernel"),
    "GammaExponentialKernel": ("hilo_mpc_tpu.ml.gp.kernels", "GammaExponentialKernel"),
    "RationalQuadraticKernel": ("hilo_mpc_tpu.ml.gp.kernels", "RationalQuadraticKernel"),
    "PiecewisePolynomialKernel": ("hilo_mpc_tpu.ml.gp.kernels", "PiecewisePolynomialKernel"),
    "DotProductKernel": ("hilo_mpc_tpu.ml.gp.kernels", "DotProductKernel"),
    "PolynomialKernel": ("hilo_mpc_tpu.ml.gp.kernels", "PolynomialKernel"),
    "LinearKernel": ("hilo_mpc_tpu.ml.gp.kernels", "LinearKernel"),
    "NeuralNetworkKernel": ("hilo_mpc_tpu.ml.gp.kernels", "NeuralNetworkKernel"),
    "PeriodicKernel": ("hilo_mpc_tpu.ml.gp.kernels", "PeriodicKernel"),
    "Warp": ("hilo_mpc_tpu.ml.gp.kernels", "Warp"),
    # optimization
    "LinearProgram": ("hilo_mpc_tpu.ops.programs", "LinearProgram"),
    "LP": ("hilo_mpc_tpu.ops.programs", "LinearProgram"),
    "QuadraticProgram": ("hilo_mpc_tpu.ops.programs", "QuadraticProgram"),
    "QP": ("hilo_mpc_tpu.ops.programs", "QuadraticProgram"),
    "NonlinearProgram": ("hilo_mpc_tpu.ops.programs", "NonlinearProgram"),
    "NLP": ("hilo_mpc_tpu.ops.programs", "NonlinearProgram"),
    # loop & data
    "SimpleControlLoop": ("hilo_mpc_tpu.control_loop", "SimpleControlLoop"),
    "DataSet": ("hilo_mpc_tpu.utils.data", "DataSet"),
    "DataGenerator": ("hilo_mpc_tpu.utils.data", "DataGenerator"),
    "Session": ("hilo_mpc_tpu.utils.session", "Session"),
    "EventFileWriter": ("hilo_mpc_tpu.utils.tb_events", "EventFileWriter"),
    "TensorBoardSupervisor": ("hilo_mpc_tpu.utils.tb_events", "TensorBoardSupervisor"),
    "set_plot_backend": ("hilo_mpc_tpu.utils.plotting", "set_plot_backend"),
    "get_plot_backend": ("hilo_mpc_tpu.utils.plotting", "get_plot_backend"),
    # cross-instance solver-trace registry (utils/trace_cache.py)
    "clear_trace_registry": ("hilo_mpc_tpu.utils.trace_cache",
                             "clear_trace_registry"),
    "trace_registry_stats": ("hilo_mpc_tpu.utils.trace_cache",
                             "trace_registry_stats"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        val = getattr(importlib.import_module(module), attr)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
