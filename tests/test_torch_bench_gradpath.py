"""The gradient-domain benchmark cell's CPU tests
(benchmark/tests/test_bench_gradpath.py), collected here too so that the
port's suite runs them: the port's reconstruction against the plain
reference and its float64 Poisson solve, the solve against a dense one,
and the control and faults that `correct` has to catch."""

from benchmark.tests.test_bench_gradpath import (  # noqa: F401
    test_control_and_faults_fail, test_dct1_matrix_is_its_own_inverse_up_to_its_scale,
    test_divergence_has_the_forks_border_factors, test_mix_keeps_the_mean_and_moves_the_differences,
    test_new_cells_resolve,
    test_new_files_keep_the_import_rules, test_port_solve_agrees_with_the_reference,
    test_program_agrees_with_the_reference, test_reference_assembles_the_gradients_as_the_port,
    test_reference_renders_lambertian_gradpath_scenes_only, test_reference_solve_is_a_dense_solve)
