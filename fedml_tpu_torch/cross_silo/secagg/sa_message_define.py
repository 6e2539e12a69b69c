"""SecAgg cross-silo message constants (copy of
``fedml_tpu.cross_silo.secagg.sa_message_define``)."""


class MyMessage:
    MSG_TYPE_CONNECTION_IS_READY = 0

    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_S2C_OTHER_PK_TO_CLIENT = 4
    MSG_TYPE_S2C_OTHER_SS_TO_CLIENT = 6
    MSG_TYPE_S2C_ACTIVE_CLIENT_LIST = 10
    MSG_TYPE_S2C_FINISH = 12

    # client -> server
    MSG_TYPE_C2S_SEND_PK_TO_SERVER = 3
    MSG_TYPE_C2S_SEND_SS_TO_SERVER = 5
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 7
    MSG_TYPE_C2S_CLIENT_STATUS = 9
    MSG_TYPE_C2S_SEND_SS_OTHERS_TO_SERVER = 11

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_MASKED_PARAMS = "masked_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"
    MSG_ARG_KEY_PK = "public_key"
    MSG_ARG_KEY_PK_OTHERS = "public_key_others"
    MSG_ARG_KEY_SS = "secret_share"
    MSG_ARG_KEY_SS_OTHERS = "secret_shares_others"
    MSG_ARG_KEY_ACTIVE_CLIENTS = "active_clients"
    MSG_ARG_KEY_CLIENT_ID = "client_id"
